#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--scale 20] [--report PATH] [--profile DIR]

Phases (any failure exits non-zero and prints no result line):

1. Build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, in parallel) and print the build time, ptxas's register and
   spill lines and the card's name and power limit; census of the two
   attention libraries (``sm90_census``): no spill stores, and tensor-core
   (HGMMA) and TMA (UTMALDG) instructions in the SASS of every kernel
   function, each instantiation counted apart; census of
   the walk kernels' six instantiations (``walk_census``): registers, no
   spill stores, and the resident blocks per SM (what the persistent grids
   are sized by); census of ``update_fused.cu``, ``alias_build.cu`` and
   ``radix_hist.cu`` (``table_census``): every kernel with a 0-byte stack
   and no spills.
2. Hold each kernel against its plain PyTorch version on the card, bit
   for bit: ``walk_fused`` over deepwalk/ppr/simple × base 2/4 × fp on/off
   × fed/hashed uniforms at C = 128 and 512 (``WALK_CAPACITIES``; 512 is
   the serving ladder's regrown width); ``walk_segment`` (the relay's segment entry)
   over the same sweep at both capacities, with start steps spread over [0, L+1], free slots,
   remote neighbours encoded -(g+2) and a permuted slot → walker id map;
   ``update_fused`` over insert/delete/mixed × five config rows, plus a
   batch wider than 2·C, and on ``streamed_state``'s states (through
   ``stream_updates`` first: a full row, an emptied row, stale member
   lists, a DENSE -> ONE rebuild) at C = 37, 256, 300 and 512 × the five
   rows,
   with its prep kernels against ``plan_round``'s torch ops; ``walk_sample`` and ``walk_sample_uniform`` over
   base 2/4 × fp on/off × gathered rows / in-place ``rows``, on batches
   holding degree-0 rows; ``radix_hist`` over K 4/16/31/32 × C 8/37/256
   (``hist_inputs``: degrees on both sides of its 32-slot short rows) and
   ``alias_build`` over ``ALIAS_KS`` (K 1 to 64; all-zero, single-entry, equal and near-1e-30 rows); ``flash_attention`` over ``FLASH_CASES``, each case
   through the kernel of its type (float32: ``flash_attention.cu``, 3xTF32
   wgmma, the output columns split over blocks past D = 256; bfloat16 and
   float16:
   ``flash_attention_sm90.cu``; the launch counters show which),
   at its limit (``flash_limit``: float32 entry by entry within 2e-5 of
   the plain version; 16-bit row by row against the all-f32
   ``flash_attention_ref32``, at most twice the plain 16-bit algorithm's
   error plus 2^-7 of the row's largest value, ``FLASH_ROW``), and the
   kernel one tile off at the band's edge (``shifted_window``) against the
   same limit, which must reject it: GQA 4:1 at Mixtral 8x7B's widths with
   its 4096 window at S = T = 8192 in bf16, D = 64 causal in f32 and
   bf16, S = 512 < T = 8192 in both, a ragged S = T = 1000 in bf16, a
   non-causal batch of two in both, in f32 a ragged S = 1000 < T = 3000 at
   D = 80, a ragged window at D = 128 and a ragged non-causal S < T at
   D = 64, and in both types hubert-xlarge's D = 80 (MHA, non-causal; its
   own width in f32, zero-padded to 128 in bf16) and the head dims run
   zero-padded, 16 and 8 (the SMOKE configs'), the last with a window;
   float16 at D = 64, 128 (Mixtral's widths) and 256; D = 256 (Gemma 2's
   16 over 8 heads) in every type, windowed, S < T and non-causal;
   D = 200 and 136, run zero-padded to 256; and past 256, where the
   output columns are split over blocks, D = 320 (run zero-padded to
   384), 384 and 512 in every type: ragged, S < T, windowed and
   non-causal.
3. The main path at full size, through ``DynamicWalkEngine.run_stream``:
   an R-MAT graph of 2^20 vertices (edge factor 8) with degree biases,
   ``BingoConfig(2**20, capacity=256, bias_bits=16)``, 10 mixed rounds of
   100,000 updates, 262,144 deepwalk walkers of length 80 after each
   round, then one ppr batch (max 400, stop 1/80) and one simple batch.
   Launch counters are zeroed just before and read just after (the
   update's prep kernels too, ``plan_round.launches``: one a round).
   Round 1's state is held against ``batched_update`` on a copy; round 10
   is replayed on a copy of round 9's state: its prepass against
   ``plan_round``'s torch ops, then through ``batched_update`` and, under
   ``torch.cuda.set_sync_debug_mode("error")`` (any host sync raises),
   through ``ops.update_fused`` (``no_sync_round``), both equal to the
   main path's state and stats.
3d. Right after the main path, on its final state, the counters zeroed
   just before and read just after: ``radix_hist(state.bias, state.deg,
   num_k=16)`` must equal ``(state.digitsum, state.gsize)`` and
   ``alias_build(group_weights(state.digitsum))`` must equal
   ``state.itable`` (written by ``update_fused`` in ten rounds), bit for
   bit, and so must the plain versions; times (median of 3) and bounds;
   the rows by degree (0, 1-8, 9-32, 33-255, 256: ``radix_hist.cu``
   counts a row of degree up to 32 in one lane, a longer one by 8).
3b. The per-step paths on the main path's final state, each with the
   counters zeroed just before and read just after: a node2vec batch
   (``WalkParams("node2vec", 80, p=0.5, q=2.0)``), a per-step deepwalk and
   a per-step simple batch (``whole_walk=False``), all through
   ``DynamicWalkEngine.walk`` from the same 262,144 starts; then 500
   mixed single-edge updates through ``stream_updates``, held against a
   host simulation of the same sequence and against a rebuild of the
   touched vertices.  Each batch is checked as the main path's are, and
   the per-step deepwalk and node2vec batches against their exact
   next-vertex distributions (TV bound derived from the sample count).
   node2vec, per-step deepwalk and per-step simple then run once more
   untimed in one ``torch.profiler`` session (``sample_launches``): the walkers in
   each ``walk_sample`` (``walk_sample_uniform`` on the simple path)
   launch, its kernel's device time, and their sums on each path.  Then
   each per-step kernel samples every walker once with fed uniforms,
   against its plain version: ``walk_sample`` at the starts,
   ``walk_sample_uniform`` at the starts and at the simple walk's
   frontier (its paths' column ``FRONTIER_STEP``, clamped at 0 as
   ``scan_walk`` clamps it), with the one uniform column its path
   passes; beside the uniform pick's word bound, the bytes it moves at
   32 bytes a sector (``uniform_sectors``).
3c. The sharded path, before the streaming updates: the parent writes the
   graph, the 10-round stream, SHA-256 digests of the 4 vertex slices of
   the main path's final state, its per-round ``UpdateStats`` and digests
   of single-device whole walks (deepwalk 262,144 × 80, ppr, simple) to a
   temporary directory, then spawns 4 ranks on the one card over gloo.
   Each builds the state, keeps its slice, replays the 10 rounds through
   ``DynamicWalkEngine(group=...)`` (slice and summed stats must equal the
   single-device ones) and walks the three batches through the relay
   (deepwalk overlapped through the engine and again bulk, ppr bulk on
   every ``PPR_RELAY_STRIDE``-th start, simple overlapped), its home
   blocks equal to the single-device paths bit for bit, the counters
   zeroed just before each batch and read just after.
   Then each gloo rank replays the four batches through a backend that
   records the work of each segment launch and its time on the card
   alone, without the wrapper's host work (``SegmentWork``), giving a
   bound per launch beside the times of the same launch.  Then one rank over NCCL runs the same deepwalk batch,
   and times the whole-walk and the segment kernels on it in turns.
3f. After the streaming updates, the main path's engine freed: the
   serving layer at full width (``serving_phase``).  A fresh engine on the
   main path's initial edges, ``BingoConfig(2**20, capacity=256,
   bias_bits=16, capacity_ladder=(256, 512))``, deepwalk 80,
   ``guard=GuardPolicy(retry_batch=65536)``, ``walk_buckets=(16384, 65536,
   262144)``, behind ``ServingScheduler(update_lanes=100_000,
   max_update_delay=4, guard_drain_rounds=8, regrow_watermark=0.95)`` with
   unbounded queues, takes seeded open-loop bursts of 1-3 requests a tick:
   the main path's 10 mixed rounds, then four insert-only windows of
   100,000 edges that a capacity-256 build drops from rows of degree at
   most 512 (``growth_edges``), and 12 walk requests of 1-65,536 starts.
   ``ServingProbe`` times each window (host ingest; the classifier by CUDA
   events beside its bytes bound), each drain and the migration (beside
   old tables read once + new written once at 3.35 TB/s), and pins the
   migrated state.  Checks: (a) a fresh engine replaying the admission
   trace returns every cohort's rows and ends in the live state (SHA-256
   ``digest``s) and guard books; (b) the migrated state's digest equals
   ``from_edges`` at 512 over its edges in row order; (c) both
   conservation laws, no ``R_CAPACITY`` quarantine before the regrow and
   each later one at a full row; (d) ``audit(pressure=True)`` at both
   tiers with every corruption rule zero (``at_capacity`` counts the full
   rows exactly while inserts wait) and ``check_state`` on ~4,096 seeded
   rows; (e) window ``NO_SYNC_WINDOW`` runs under
   ``torch.cuda.set_sync_debug_mode("error")``; (f) with the counters
   zeroed just before the run and read just after, ``walk_fused``
   launches equal the cohorts and ``update_fused`` launches the windows
   plus the retry rounds.  Then ``recovery_phase`` at 2^17 vertices, the
   same widths: ``RecoverableEngine(checkpoint_every=3)`` over 10 guarded
   rounds and walks, a regrow record logged and the engine dropped before
   it migrates; ``restore`` + WAL replay must give the uninterrupted run's
   state digest and next walk batch.  Prints cohort latency p50/p99, walk
   steps/s and updates/s over the phase, snapshot and restore times.
3g. After recovery: the sharded serving layer.  Phase 3f hands over its
   traffic, admission trace, per-request path digests, guard books,
   regrow counts, the digests of the 4 vertex slices of its final state
   and a single-device whole walk of that state (65,536 deepwalk starts,
   ``CHAOS_SEED``).  4 gloo ranks on the one card build their slices in
   turn and run phase 3f's bursts through a ``ServingScheduler`` over
   ``DynamicWalkEngine(group=..., guard=GuardPolicy(retry_batch=65536),
   walk_buckets=..., relay_overlap=False)`` at the ladder 256 -> 512 (bulk
   relays: the faster schedule on gloo).  Each rank must admit phase 3f's
   trace op for op (the harvest blocks on a sharded engine; if phase 3f's
   own dispatch ever met ``max_inflight``, its trace is replayed instead)
   and give every request's paths, the guard books, the regrow counts and
   its final slice as phase 3f did; launches equal the relay rounds and
   the windows plus retry rounds; the summed ``audit`` has no corruption.
   Then, on the grown state, ``run_chaos_relay`` with dup 0.2 + delay 0.2
   must give the single-device walk with no walker lost, and drop 0.01
   and a transport killed at round 3 must raise ``RelayIntegrityError``
   on every rank.  Last, one NCCL rank runs phase 3f's second window on a
   sharded engine under ``set_sync_debug_mode("error")`` (gloo stages
   every collective through the host, so a gloo rank cannot).  Prints
   request latency, rates, drains, migrations and the classifier's ms a
   rank, relay rounds per cohort, the chaos reports and the phase's
   seconds, each beside the card's name and power limit.
3h. After phase 3g: the 2D vertex x walker mesh.  4 gloo ranks on the one
   card form a ``MESH_SHAPE`` ``DeviceMesh`` ``MESH_DIMS`` (rank r = v·2 +
   g: S_v = 2 vertex shards of 2^19 rows, S_w = 2 walker groups).  Each
   builds the main path's initial state in turn and keeps two engines on
   the rows of its vertex index (``DynamicWalkEngine(mesh=...,
   walker_axes=WALKER_AXES)``): (1) the main path's 10 rounds through one
   (stats equal to the single device's, counted once; its slice equal to
   the single device's rows), then 262,144 deepwalk starts of length 80
   (131,072 a walker group) overlapped through the engine and bulk
   through ``make_relay(mesh=...)``, and one simple batch bulk
   (``MESH_BATCHES``): each rank's stitched paths have the SHA-256 of
   phase 3c's single-device walk, the peak slots stay within a group's
   pool (``slot_count(131072, 2)``), launches equal the rounds; (2)
   phase 3f's configuration, traffic and seeds through the other
   (guarded, buckets, bulk relays) behind a ``ServingScheduler``, as in
   phase 3g: the admission trace, every request's paths, the guard
   books, the regrow counts and each rank's final rows (both replicas of
   a vertex shard) equal phase 3f's; (3) on the grown state,
   ``run_chaos_relay`` over the mesh with dup 0.2 + delay 0.2 on 65,536
   starts: phase 3f's single-device paths, nothing lost or pending.
   Then (4), in this process, the comparison samplers
   (``core/baselines.py``) on the edges of the main path's final state
   (2^20 x 256): each built, one step of the 262,144 starts timed beside
   B4a's (this run), ``BASELINE_UPDATES`` inserts and deletes through
   each; the touched alias rows equal a fresh build, the ITS prefix sums
   a fresh cumulative sum, ``wmax`` the rows' maxima.
3i. After phase 3h: the LM serving path (``lm_phase``),
   ``examples/graph_serve.py``'s loop at qwen2-0.5b's full width.  An
   R-MAT graph of 2^17 vertices (edge factor 8, degree biases,
   ``BingoConfig(2**17, capacity=256, bias_bits=8)``) and
   ``get_config("qwen2-0.5b")`` (24 layers, d_model 896, vocab 151,936,
   bf16 activations over float32 params, random init from a seed) behind
   ``DecodeEngine(slots=8, max_len=64)``, greedy.  Two waves of 16
   requests: a deepwalk of length 12 from 16 random vertices (B1), each
   path's first 16 valid vertices the prompt, 8 new tokens; between the
   waves one ``batched_update`` round of 4,096 random inserts through
   the backend (B2).  The counters zeroed just before and read just
   after: ``walk_fused`` 2, ``update_fused`` 1 (and one ``plan_round``),
   nothing else.  Checks: the walks equal ``walk_fused_ref`` and the
   round ``batched_update`` on a copy; every consecutive pair of a prompt
   is an edge of that wave's state; every request ends with 8 tokens
   below the vocabulary.  Prints ms a tick, tokens/s and the peak memory
   beside the card's name and power limit.  Then decode against forward
   on the card, counters zeroed (the model path launches none of the
   seven kernels): qwen2-0.5b FULL over a 32-token prompt (bf16 decode
   within twice bf16 forward's distance from the float32 forward plus
   2^-7 of the logits' scale, ``LM_BF16_STEP``; float32 decode within
   ``LM_F32_TOL`` of float32 forward); every other arch at its SMOKE
   config in float32 (decode against forward within ``LM_SMOKE_ATOL``;
   hubert and llava forward only, with embeddings), each against the
   same params on the CPU (``lm_cpu_limit``); Mixtral
   8x7B's widths at one layer (~1.7 B params) the same bf16 check, and
   its ragged MoE against the dense one in float32.
3j. After phase 3i: training (``train_phase``), ``launch/train.py``'s
   loop at qwen2-0.5b's full width on a live walk corpus.  An R-MAT
   graph of 2^17 vertices (edge factor 8, ``degree_bias(bias_bits=10)``,
   ``BingoConfig(2**17, capacity=256, bias_bits=10)``); the update
   stream ``make_update_stream(batch_size=256, rounds=10, mode="mixed",
   seed=1)``, a round through ``make_updater`` every 10 steps (B2);
   ``WalkCorpusPipeline(walkers_per_round=512, seq_len=512,
   batch_size=8)``, a deepwalk round of length 16 (B1) whenever its
   buffer runs short; ``get_config("qwen2-0.5b")`` with the walk
   vocabulary (2^17 + 1 tokens, ``frontend="none"``, random weights from
   a seed), ``OptConfig(warmup_steps=10, total_steps=40)`` (the default
   lr, 3e-4: the driver's 3e-3 is meant for its 4-layer LM) and
   ``make_train_step(remat="none")``, 40 steps.  The counters zeroed
   just before and read just after: ``walk_fused`` equal to the rounds
   produced, ``update_fused`` 3 (and three ``plan_round``s), nothing
   else.  Checks: round 1's paths equal ``walk_fused_ref``; each update
   round equals ``batched_update`` on a copy; every consecutive pair of
   vertex tokens the pipeline packs is an edge of the state its round
   was sampled from; every loss finite, and the mean of the last 5
   losses ``TRAIN_LOSS_DROP`` below the first.  Prints ms a step
   (median, mean, first; a sync on either side) beside the pipeline's
   walk and pack ms (timed apart), tokens/s, model TFLOP/s (6 N tokens)
   beside the bf16 tensor-core peak, the peak memory, the host syncs of
   one more step (``set_sync_debug_mode("warn")``) and the f32 head
   product with its two gradient products timed alone beside their
   bound.  Then, counters zeroed (the model path launches no kernel), at
   the same width on 4 x 512 tokens: the bf16 loss against the f32 loss
   within one bf16 step (2^-7) of it; ``remat`` "full" and "dots"
   against "none" (loss equal, every gradient within ``TRAIN_GRAD_TOL``
   of its leaf's largest value); float32 ``microbatches=4`` against 1
   at the same limit; a ``compress=True`` step with finite error
   feedback; every SMOKE arch's ``loss_fn`` and gradients on the card
   against the CPU (``lm_cpu_limit``'s tolerances, per leaf); two
   bfloat16-moment steps and a checkpoint of ``{"params", "opt"}``
   restored bit for bit.  Last, ``repro_torch.launch.train.main`` on
   the card with ``examples/train_walk_lm.py``'s arguments, 30 steps,
   checkpoints every 10, into a temporary directory (the restored tree
   equal to the saved one bit for bit), then with 40 steps, which must
   resume from step 30.
3k. After phase 3j: the dry run of the walk cells (``dryrun_phase``).
   ``python -m repro_torch.launch.dryrun --all --arch-filter bingo-walk``
   in a subprocess: the eight cells on a fake world of 256 ranks (fake tensors, nothing
   launched), every cell must run; beside it, in another, the dry run
   of one rank's share on a fake world of one.  Then that share of FULL (its
   163,840 rows at C = 1024, 16 bias bits, 16,384 walkers of L = 80,
   102,400-update batches; the serving round's walk bucket cut to 256 of
   its 65,536 starts) on a power-law graph of mean degree 35, capped at
   C (``rank_graph``): ``walk_step``, ``walk_whole``, ``update_step``,
   ``update_walk``, ``walk_relay``, ``serve_round`` and ``update_walk`` at
   C' = 2C (``RANK_CELLS``), each for real through ``build_walk_cell``
   on ``make_local_mesh()`` (a one-rank NCCL group;
   ``rank_cell_checks``): the argument bytes must equal the dry run's,
   the fake peak be at most 10 % under the real one
   (``RANK_PEAK_UNDER``), each cell's kernels (B4a; B1; B2; B2 + B1; B3;
   B3 + B2) must launch, and its outputs (paths, updated state, stats)
   must equal the same cell's built on ``plain_backend()`` (each
   kernel's plain version, the same draws) at C = 1024 and 2048; the
   real ms (median of 3) beside the
   predicted max(compute, memory) and the kernel byte model beside the
   walks' real needs are printed.  Last, one dependent row gather's
   latency (``dma_latency``: B1 with 2 walkers an SM, ms / L) beside
   ``launch/hw.py``'s ``DMA_LATENCY``, and the card's ``total_memory``
   beside ``HBM_BYTES``.
3l. After phase 3k: the dry run's LM cells (``lm_dryrun_phase``).
   qwen2-0.5b's ``train_4k``, ``prefill_32k`` and ``decode_32k``
   through ``dryrun --all --arch-filter qwen2-0.5b`` on a fake world of
   256 ranks (DTensor params, moments, batch and cache; fake tensors on
   ``cuda``; every cell must run), and beside it at one rank's share on
   a fake world of one (``--mesh 1x1 --sizing rank``: each shape's
   global batch cut to 1), and jamba-v0.1-52b's and xlstm-350m's cells
   (all four shapes each) at SMOKE on a fake 2 x 2 world (``--mesh 2x2
   --sizing smoke``); all start beside phase 3k's dry runs and
   are collected with them, before 3k's timed part
   (``lm_dryrun_start``, ``lm_dryrun_collect``).  This torch's counts
   must equal the committed records, written on the CPU's torch
   (``lm_record_checks``, ``record_check``): qwen2-0.5b decode_32k's
   FLOPs a rank on 256 ranks within 1e-6 (its other two cells printed
   beside their records), and the recurrent archs' SMOKE cells' FLOPs,
   bytes and collective bytes a rank within 1e-6 and peaks within 1 %
   (``experiments/dryrun_torch/smoke2x2/``).  Then the counter
   on fake ``cuda`` DTensors of this torch (``counter_check``: an FSDP x
   TP matmul counts the rank's local work and the weight's all-gather,
   a second call and a second SMOKE decode cell count what the first
   did).  Then that share for real at FULL width
   (vocab 151,936, 24 layers, bf16 compute) through ``build_cell`` on
   ``make_local_mesh()`` over a one-rank NCCL group
   (``lm_rank_cell_checks``): argument bytes equal the dry run's, the
   fake peak at most 10 % under the real one, the DTensor cell's outputs
   (the step's loss, params and moments; prefill's last-position
   logits; decode's logits and cache) equal to the same function on
   plain tensors bit for bit (the k projection's bias, whose gradient
   is zero in exact arithmetic, within 1e-6: ``LM_NOISE_LEAVES``), no
   kernel launched (the LM cells call none); real ms (median of 3)
   beside the predicted max(compute, memory) and their ratio, printed.
3m. After phase 3l: the LM cells on a real 2 x 2 mesh (``lm_mesh_phase``).
   Four ranks share the card (``spawn_ranks``, ``lm_mesh_rank``), each
   building ``init_device_mesh("cuda", (2, 2), ("data", "model"))`` over
   a world of ``HOST_STAGED`` groups (``register_host_staging``: gloo
   with each collective's CUDA buffers staged through the host, since
   gloo's own CUDA all-gather, reduce-scatter and all-to-all crash torch
   2.11; the collectives and their bytes are the model's, tallied by
   kind).  The cells are ``build_cell``'s train, prefill and decode on
   DTensors placed by ``place``: qwen2-0.5b at FULL width (d_model 896,
   14 heads, 2 KV heads, d_ff 4,864, vocab 151,936) cut to 2 layers, a
   train batch of 4 x 128 in 2 microbatches whose rows are a deepwalk
   round (B1, ``lm_mesh_walk_batch``, seeded alike on every rank and
   checked against ``walk_fused_ref``), a prefill of 2 x 512 and a
   decode at position 5 of a 512-slot cache; and mixtral-8x7b's,
   jamba-v0.1-52b's and xlstm-350m's at SMOKE (train 2 x 16, one
   microbatch; prefill and decode 4 x 16): the dense experts, mamba and
   the mLSTM / sLSTM on shards.  Rank 0 holds each against the same
   function on whole tensors on the card, float32, TF32 off, at
   ``LM_MESH_TOL`` (the train step's loss and gradient norm rtol 1e-5,
   params and moments rtol 1e-5 / atol 1e-6, second moments atol 1e-9;
   logits atol 1e-5 of the largest; the cache one bf16 ulp; xlstm's, an
   ill-conditioned stack, at twice the share of each limit that the same
   plain run on the CPU uses where that is more, ``LM_MESH_FLOOR``);
   each cell's wall time (its first call: DTensor's planning included),
   each rank's collectives by kind and peak are printed beside the counter's
   prediction for the same cell on a fake 2 x 2 world
   (``lm_mesh_predictions``, run while the ranks start), and each kind's
   bytes a rank must be within ``LM_MESH_COLL_RTOL`` (1 %) of it.
3e. Last, attention over ``ATTN_CASES``, one launch each: at Mixtral
   8x7B's widths (32 query heads, 8 KV heads, D = 128) over one
   32,768-token sequence (``prefill_32k``): in bf16 the 4096 window and
   full causal, in f32 the window; and at hubert-xlarge's (16 heads, MHA,
   D = 80, non-causal) in bf16 (zero-padded to 128 by the wrapper) and
   f32 (the 80-wide instantiation); over 8,192 tokens Gemma 2 9B's (16
   over 8 heads, D = 256, window 4096) in bf16, f16 and f32, D = 200
   (zero-padded to 256), Mixtral's widths in f16 (causal),
   qwen2-0.5b's (14 over 2 heads, D = 64) in all three types, and
   Gemma's heads and window at D = 512 and 384 in all three types; the
   counters zeroed just before and read just after each case;
   256 query rows of each output held
   against the dense ``attention_ref`` in f32 and the whole output
   against the plain version, at the limits of phase 2, which must reject
   the planted fault at this size; kernel times (median of 3), the FLOP
   bound (16-bit at the dense tensor-core rate; f32 three TF32 products
   at the dense TF32 rate, with the bound at the float32 CUDA-core rate
   printed for the record),
   and ``scaled_dot_product_attention`` on the same tensors as the
   library yardstick (a boolean mask for the window; its math backend
   where no fused one takes the input and the logits fit).
4. Times on the card (CUDA events): each kernel at the main path's shapes
   and its plain version, whose outputs are held against the main path's
   whole batches (deepwalk, ppr and simple paths; the state after round
   10; a per-step sample of all 262,144 walkers); each kernel's bound
   from the work this run's data needs; the wall time of each walk batch
   and of each streaming update.  Prints a ``{"kernels": [...]}`` line
   and, last, ``{"ok": true, "device": {...}}``.

Needs one card, the CUDA toolkit (nvcc) and nothing from the network.
The sharded phase spawns its ranks with the ``spawn`` start method and
stops them all, whatever happens.  Each phase's seconds and the total
are printed before the result lines.  ``--scale`` cuts the graph for a
quicker run (phase 3f's growth windows then shrink to the hub-row edges
there are);
``--report`` writes every number measured to a JSON file;
``--profile DIR`` adds, after the per-step paths, one profiled round
(``torch.profiler``; the ingest's host ops, device events and host syncs
by ``trace_counts``) and one profiled batch of each per-step path, and
writes the round's trace there.
"""

import argparse
import dataclasses
import datetime
import gc
import hashlib
import json
import math
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from functools import partial
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch import hw  # noqa: E402  (the card's constants)
from repro_torch.launch.roofline import MEAN_DEGREE, bound  # noqa: E402,F401
WALK_LEN, PPR_LEN, PPR_STOP = 80, 400, 1.0 / 80.0
FRONTIER_STEP = 40                 # B4b timed on this column of simple paths
N2V_P, N2V_Q = 0.5, 2.0
CHECK_WALKERS = 4096
STREAM_UPDATES = 250
SHARDS = 4                         # ranks of the sharded phase, on one card
SHARD_TIMEOUT_S = 420              # the sharded phase's ranks, all together
RELAY_SEEDS = {"deepwalk": 101, "ppr": 102, "simple": 103}
PPR_RELAY_STRIDE = 16              # phase 3c's ppr relay: every 16th start
# (B, H, Hkv, S, T, D, dtype, causal, window): flash_attention vs plain
FLASH_CASES = [
    (1, 32, 8, 8192, 8192, 128, "bfloat16", True, 4096),    # Mixtral widths
    (1, 8, 2, 2048, 2048, 64, "float32", True, 0),
    (1, 8, 2, 512, 8192, 128, "float32", True, 0),          # S < T
    (1, 4, 2, 1000, 1000, 64, "bfloat16", True, 300),       # ragged
    (2, 4, 1, 1536, 1536, 128, "float32", False, 0),        # non-causal
    (2, 4, 1, 1536, 1536, 128, "bfloat16", False, 0),       # non-causal
    (1, 8, 2, 512, 8192, 128, "bfloat16", True, 0),         # S < T
    (1, 8, 2, 2048, 2048, 64, "bfloat16", True, 0),         # D = 64 causal
    # head dims without a kernel of their own, run zero-padded to the
    # route's next width (bf16 64 / 128; f32 64 / 80 / 128)
    (1, 16, 16, 1024, 1024, 80, "bfloat16", False, 0),      # hubert-xlarge
    (1, 16, 16, 1024, 1024, 80, "float32", False, 0),       # f32: its own width
    (1, 4, 2, 600, 600, 16, "bfloat16", True, 0),           # xlstm SMOKE
    (1, 4, 2, 600, 600, 16, "float32", True, 0),
    (2, 8, 8, 512, 512, 8, "bfloat16", True, 128),          # SMOKE configs
    (2, 8, 8, 512, 512, 8, "float32", True, 128),
    # f32: ragged S < T at D = 80, a ragged window, ragged non-causal S < T
    (1, 8, 2, 1000, 3000, 80, "float32", True, 0),
    (1, 4, 2, 777, 777, 128, "float32", True, 300),
    (2, 4, 4, 333, 1000, 64, "float32", False, 0),
    # float16 (the bf16 kernel's other instantiation), at each width
    (1, 32, 8, 2048, 2048, 128, "float16", True, 0),        # Mixtral widths
    (2, 4, 1, 1536, 1536, 64, "float16", False, 0),
    (1, 4, 2, 1000, 1000, 256, "float16", True, 300),       # ragged window
    # D = 256 (Gemma 2's heads: 16 over 8 KV heads) in every type, and
    # widths between 128 and 256, run zero-padded to 256
    (1, 16, 8, 1024, 1024, 256, "bfloat16", True, 512),
    (1, 16, 8, 1024, 1024, 256, "float32", True, 512),
    (1, 4, 2, 512, 1500, 256, "bfloat16", True, 0),         # S < T
    (1, 4, 2, 512, 1500, 256, "float32", True, 0),
    (2, 4, 4, 333, 700, 256, "bfloat16", False, 0),         # non-causal
    (2, 4, 4, 333, 700, 256, "float32", False, 0),
    (1, 4, 2, 777, 777, 200, "bfloat16", True, 0),
    (1, 4, 2, 777, 777, 200, "float32", True, 300),
    (1, 4, 2, 600, 600, 136, "float16", False, 0),
    (1, 4, 2, 600, 600, 136, "float32", True, 0),
    # past 256, the output columns split over blocks: 320 (run zero-padded
    # to 384), 384 and 512 in every type; ragged, S < T, windowed and
    # non-causal
    (1, 4, 2, 777, 777, 320, "bfloat16", True, 300),        # ragged window
    (1, 4, 2, 777, 777, 320, "float32", True, 300),
    (1, 4, 2, 512, 1500, 320, "float16", True, 0),          # S < T
    (1, 4, 2, 512, 1500, 320, "float32", True, 0),
    (2, 4, 4, 333, 700, 320, "bfloat16", False, 0),         # non-causal
    (2, 4, 4, 333, 700, 320, "float16", False, 0),
    (1, 4, 2, 600, 600, 384, "bfloat16", True, 0),
    (1, 4, 2, 600, 600, 384, "float32", False, 0),
    (1, 16, 8, 1024, 1024, 512, "bfloat16", True, 512),     # Gemma's heads
    (1, 16, 8, 1024, 1024, 512, "float16", True, 512),
    (1, 16, 8, 1024, 1024, 512, "float32", True, 512),
    (1, 4, 2, 512, 1500, 512, "bfloat16", True, 0),         # S < T
    (1, 4, 2, 512, 1500, 512, "float32", True, 0),
    (2, 4, 4, 333, 700, 512, "float16", False, 0),          # non-causal
    (2, 4, 4, 333, 700, 512, "float32", False, 0),
    (1, 4, 2, 1000, 1000, 512, "bfloat16", True, 300),      # ragged window
]
# float32: |kernel - plain| <= atol + rtol * |plain|, entry by entry, to
# the accumulation order.  The bfloat16 entry is the limit of the CUDA-core
# bf16 kernel this repository had before the tensor-core one; it is read
# for the record only
FLASH_TOL = {"float32": (2e-5, 0.0), "bfloat16": (2e-5, 2.0 ** -7)}
# bfloat16, row by row against the all-float32 algorithm (ref32): for each
# query row, max_d |kernel - ref32| <= k * max_d |plain16 - ref32| + step *
# max_d |ref32|: no less accurate than the plain bf16 algorithm (P rounded
# to bf16, as the tensor cores take it) twice over, plus one bf16 output
# step at the row's scale
FLASH_ROW = (2.0, 2.0 ** -7)
# phase 3e: Mixtral 8x7B's attention (configs/mixtral_8x7b.py) over one
# prefill_32k sequence (configs/shapes.py)
ATTN_HEADS, ATTN_KV_HEADS, ATTN_DIM = 32, 8, 4096 // 32
ATTN_SEQ, ATTN_WINDOW = 32768, 4096
# and hubert-xlarge's (configs/hubert_xlarge.py: 16 heads, MHA, d_model
# 1280, non-causal), the same sequence
HUBERT_HEADS, HUBERT_DIM = 16, 1280 // 16
# Gemma 2 9B's attention (HF google/gemma-2-9b config: 16 query heads over
# 8 KV heads, head_dim 256, sliding_window 4096) over one 8,192-token
# sequence; qwen2-0.5b's (14 over 2, D = 64) over the same
GEMMA_HEADS, GEMMA_KV_HEADS, GEMMA_DIM, GEMMA_WINDOW = 16, 8, 256, 4096
QWEN_HEADS, QWEN_KV_HEADS, QWEN_DIM = 14, 2, 64
WIDE_SEQ = 8192
# SDPA's math backend is phase 3e's yardstick where no fused backend takes
# the input, if its whole f32 logits are at most this many bytes (it holds
# about three such copies: Gemma's 16 heads over 8,192 tokens 4.3 GB)
SDPA_MATH_LOGITS = 16 << 30
# phase 3e: (name, heads, KV heads, D, S = T, type, causal, window); every
# kernel instantiation (16-bit at 64, 128, 256, 384, 512; float32 at 64,
# 80, 128, 256, 384, 512) and a width padded to 256 (D = 200)
ATTN_CASES = (
    ("window", ATTN_HEADS, ATTN_KV_HEADS, ATTN_DIM, ATTN_SEQ, "bfloat16",
     True, ATTN_WINDOW),
    ("causal", ATTN_HEADS, ATTN_KV_HEADS, ATTN_DIM, ATTN_SEQ, "bfloat16",
     True, 0),
    ("window f32", ATTN_HEADS, ATTN_KV_HEADS, ATTN_DIM, ATTN_SEQ, "float32",
     True, ATTN_WINDOW),
    ("hubert", HUBERT_HEADS, HUBERT_HEADS, HUBERT_DIM, ATTN_SEQ, "bfloat16",
     False, 0),
    ("hubert f32", HUBERT_HEADS, HUBERT_HEADS, HUBERT_DIM, ATTN_SEQ,
     "float32", False, 0),
    ("gemma window", GEMMA_HEADS, GEMMA_KV_HEADS, GEMMA_DIM, WIDE_SEQ,
     "bfloat16", True, GEMMA_WINDOW),
    ("gemma window f16", GEMMA_HEADS, GEMMA_KV_HEADS, GEMMA_DIM, WIDE_SEQ,
     "float16", True, GEMMA_WINDOW),
    ("gemma window f32", GEMMA_HEADS, GEMMA_KV_HEADS, GEMMA_DIM, WIDE_SEQ,
     "float32", True, GEMMA_WINDOW),
    ("d200", GEMMA_HEADS, GEMMA_KV_HEADS, 200, WIDE_SEQ, "bfloat16", True, 0),
    ("mixtral f16", ATTN_HEADS, ATTN_KV_HEADS, ATTN_DIM, WIDE_SEQ, "float16",
     True, 0),
    ("qwen2", QWEN_HEADS, QWEN_KV_HEADS, QWEN_DIM, WIDE_SEQ, "bfloat16",
     True, 0),
    ("qwen2 f16", QWEN_HEADS, QWEN_KV_HEADS, QWEN_DIM, WIDE_SEQ, "float16",
     True, 0),
    ("qwen2 f32", QWEN_HEADS, QWEN_KV_HEADS, QWEN_DIM, WIDE_SEQ, "float32",
     True, 0),
    # past 256: Gemma's heads and window at D = 512 and 384, the output
    # columns split over two blocks (16 bits) or D / 128 (f32)
    ("gemma d512", GEMMA_HEADS, GEMMA_KV_HEADS, 512, WIDE_SEQ, "bfloat16",
     True, GEMMA_WINDOW),
    ("gemma d512 f16", GEMMA_HEADS, GEMMA_KV_HEADS, 512, WIDE_SEQ,
     "float16", True, GEMMA_WINDOW),
    ("gemma d512 f32", GEMMA_HEADS, GEMMA_KV_HEADS, 512, WIDE_SEQ,
     "float32", True, GEMMA_WINDOW),
    ("gemma d384", GEMMA_HEADS, GEMMA_KV_HEADS, 384, WIDE_SEQ, "bfloat16",
     True, GEMMA_WINDOW),
    ("gemma d384 f16", GEMMA_HEADS, GEMMA_KV_HEADS, 384, WIDE_SEQ,
     "float16", True, GEMMA_WINDOW),
    ("gemma d384 f32", GEMMA_HEADS, GEMMA_KV_HEADS, 384, WIDE_SEQ,
     "float32", True, GEMMA_WINDOW),
)


class SmokeFailure(RuntimeError):
    pass


def need(cond, what):
    if not cond:
        raise SmokeFailure(what)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=3, setup=None):
    """``(median device ms, last result)`` of ``fn()`` over ``reps`` runs
    (CUDA events; ``setup()`` runs untimed before each and its result is
    passed to ``fn``).  A spin kernel of about 1 ms runs before the first
    event, so the host enqueues ``fn``'s launches while the card is busy
    and a kernel shorter than its wrapper's host work is timed on the
    card alone."""
    import torch
    times, out = [], None
    for _ in range(reps):
        arg = setup() if setup else None
        out = None
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        out = fn(arg) if setup else fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2], out


def clone_state(st):
    from repro_torch.core.alias import AliasTable
    return st._replace(**{f: (None if getattr(st, f) is None
                              else getattr(st, f).clone())
                          for f in st._fields if f != "itable"},
                       itable=AliasTable(st.itable.prob.clone(),
                                         st.itable.alias.clone()))


def state_diff(a, b, what):
    """Max abs difference over every leaf of two states; fails the run
    unless they are bit-equal, so a returned value is 0.0."""
    import torch
    worst, bad = 0.0, []
    for name, x, y in zip(a._fields, a, b):
        if name == "itable":
            pairs = [("prob", x.prob, y.prob), ("alias", x.alias, y.alias)]
        else:
            pairs = [(name, x, y)]
        for n, p, q in pairs:
            if p is None:
                need(q is None, f"{what}: state leaf {n} None on one side only")
                continue
            if not torch.equal(p, q):
                d = (p.double() - q.double()).abs().max().item()
                worst = max(worst, d if d == d else float("inf"))
                bad.append(n)
    need(not bad, f"{what}: state leaves {bad} differ (max abs {worst})")
    return worst


def path_diff(got, want, what):
    """Max abs difference of two path tensors; fails unless equal."""
    err = float((got.long() - want.long()).abs().max())
    need(err == 0.0, f"{what}: kernel paths != plain (max abs {err}, "
         f"{int((got != want).sum())} entries differ)")
    return err


def random_graph(rng, V, C, bits):
    deg = rng.integers(1, C + 1, V)
    src = np.repeat(np.arange(V), deg).astype(np.int32)
    dst = rng.integers(0, V, src.size).astype(np.int32)
    w = rng.integers(1, 1 << bits, src.size).astype(np.int32)
    return src, dst, w


# ---------------------------------------------------------------- phase 2
WALK_CAPACITIES = (128, 512)        # phase 2's walk sweep; 512 is the
                                    # serving ladder's regrown width


def check_walk_kernel(rng):
    V, bits, B, L = 4096, 12, 2048, 24
    n = 0
    for C in WALK_CAPACITIES:
        src, dst, w = random_graph(rng, V, C, bits)
        keep = rng.random(V) >= 0.02                   # some dead ends
        keep = keep[src]
        n += walk_sweep(rng, V, C, bits, B, L, src[keep], dst[keep],
                        w[keep])
    return n


def walk_sweep(rng, V, C, bits, B, L, src, dst, w):
    """``walk_fused`` == plain over deepwalk/ppr/simple × base 2/4 × fp
    on/off × fed/hashed uniforms on one graph of capacity C."""
    import torch
    from repro_torch.core import dyngraph as dg
    from repro_torch.kernels import ops
    from repro_torch.kernels.walk_fused import walk_fused_ref
    n = 0
    for base_log2 in (1, 2):
        for fp in (False, True):
            wv = w.astype(np.float32) + rng.random(w.size).astype(np.float32) \
                if fp else w
            cfg = dg.BingoConfig(num_vertices=V, capacity=C, bias_bits=bits,
                                 base_log2=base_log2, fp_bias=fp, lam=4.0)
            st = dg.from_edges(cfg, src, dst, wv, device="cuda")
            starts = torch.from_numpy(rng.integers(0, V, B).astype(np.int32)).cuda()
            for kind in ("deepwalk", "ppr", "simple"):
                for fed in (True, False):
                    u = torch.from_numpy(rng.random((L, B, 6)).astype(
                        np.float32)).cuda() if fed else None
                    kw = dict(base_log2=base_log2, uniform=kind == "simple",
                              stop_prob=0.15 if kind == "ppr" else 0.0)
                    args = (st.itable.prob, st.itable.alias, st.bias, st.nbr,
                            st.deg, st.frac if fp else None, starts)
                    seed = int(rng.integers(0, 2**31 - 1))
                    got = ops.walk_fused(*args, seed, u, length=L, **kw)
                    want = walk_fused_ref(*args, u, seed=seed, length=L, **kw)
                    torch.cuda.synchronize()
                    need(torch.equal(got, want),
                         f"walk_fused != plain ({kind}, C={C}, base "
                         f"2^{base_log2}, fp={fp}, fed={fed})")
                    n += 1
    return n


def check_segment_kernel(rng):
    """The segment entry == ``walk_segment_ref``, bit for bit, at each of
    ``WALK_CAPACITIES`` (512: the relay's rows after the serving ladder's
    regrow)."""
    V, bits = 4096, 12
    n = 0
    for C in WALK_CAPACITIES:
        src, dst, w = random_graph(rng, V, C, bits)
        keep = (rng.random(V) >= 0.02)[src]            # some dead ends
        n += segment_sweep(rng, V, C, bits, src[keep], dst[keep], w[keep])
    return n


def segment_sweep(rng, V, C, bits, src, dst, w):
    """``walk_segment`` == plain over deepwalk/ppr/simple × base 2/4 × fp
    on/off × fed/hashed uniforms on one graph of capacity C, on a relay
    view (remote neighbours encoded -(g+2)) with start steps spread over
    [0, L+1], free slots and a permuted slot → walker id map."""
    import torch
    from repro_torch.core import dyngraph as dg
    from repro_torch.distributed.relay import relay_view
    from repro_torch.kernels import ops
    from repro_torch.kernels.walk_fused import walk_segment_ref
    B, L = 2048, 24
    lo, Vs = 1024, 2048                                # this view's shard
    n = 0
    for base_log2 in (1, 2):
        for fp in (False, True):
            wv = w.astype(np.float32) + rng.random(w.size).astype(np.float32) \
                if fp else w
            cfg = dg.BingoConfig(num_vertices=V, capacity=C, bias_bits=bits,
                                 base_log2=base_log2, fp_bias=fp, lam=4.0)
            view = relay_view(dg.from_edges(cfg, src, dst, wv, device="cuda"),
                              lo, Vs)
            need(bool((view.nbr <= -2).any()), "no remote neighbours")
            starts = torch.from_numpy(rng.integers(-1, Vs, B).astype(np.int32)).cuda()
            t0 = torch.from_numpy(rng.integers(0, L + 2, B).astype(np.int32)).cuda()
            t0[:2] = torch.tensor([L, L + 1], dtype=torch.int32)
            wid = torch.from_numpy(rng.permutation(B).astype(np.int32)).cuda()
            args = (view.itable.prob, view.itable.alias, view.bias, view.nbr,
                    view.deg, view.frac if fp else None, starts, t0)
            for kind in ("deepwalk", "ppr", "simple"):
                for fed in (True, False):
                    u = torch.from_numpy(rng.random((L, B, 6)).astype(
                        np.float32)).cuda() if fed else None
                    kw = dict(length=L, base_log2=base_log2,
                              uniform=kind == "simple",
                              stop_prob=0.15 if kind == "ppr" else 0.0)
                    seed = int(rng.integers(0, 2**31 - 1))
                    got = ops.walk_segment(*args, seed, u, wid, **kw)
                    want = walk_segment_ref(*args, u, wid, seed=seed, **kw)
                    torch.cuda.synchronize()
                    what = (f"{kind}, C={C}, base 2^{base_log2}, fp={fp}, "
                            f"fed={fed}")
                    need(all(torch.equal(a, b) for a, b in zip(got, want)),
                         f"walk_segment != plain ({what})")
                    need(bool((got[1][:, 0] >= 0).any()),
                         f"walk_segment: no frontier exit ({what})")
                    n += 1
    return n


def check_sample_kernels(rng):
    """Both per-step kernels == their plain versions, bit for bit, over
    base 2/4 × fp on/off × gathered / in-place rows (and 3 or 5 uniform
    columns on the base-2 integer path); every batch holds degree-0 rows."""
    import torch
    from repro_torch.core import dyngraph as dg
    from repro_torch.kernels import ops
    from repro_torch.kernels.walk_sample import (walk_sample_ref,
                                                walk_sample_uniform_ref)
    V, C, bits, B = 4096, 128, 12, 8192
    src, dst, w = random_graph(rng, V, C, bits)
    keep = (rng.random(V) >= 0.05)[src]                # degree-0 rows
    src, dst, w = src[keep], dst[keep], w[keep]
    n = 0
    for base_log2 in (1, 2):
        for fp in (False, True):
            wv = w.astype(np.float32) + rng.random(w.size).astype(np.float32) \
                if fp else w
            cfg = dg.BingoConfig(num_vertices=V, capacity=C, bias_bits=bits,
                                 base_log2=base_log2, fp_bias=fp, lam=4.0)
            st = dg.from_edges(cfg, src, dst, wv, device="cuda")
            tabs = (st.itable.prob, st.itable.alias, st.bias, st.nbr, st.deg)
            rows = torch.from_numpy(rng.integers(0, V, B).astype(np.int32)).cuda()
            need(bool((st.deg[rows.long()] == 0).any()), "no degree-0 rows")
            for in_place in (True, False):
                if in_place:
                    args, frac, kw = tabs, st.frac if fp else None, {"rows": rows}
                else:
                    r = rows.long()
                    args = tuple(x[r].contiguous() for x in tabs)
                    frac, kw = (st.frac[r].contiguous() if fp else None), {}
                for ncols in ((3, 5) if base_log2 == 1 and not fp else (5,)):
                    u = torch.from_numpy(rng.random((B, ncols)).astype(
                        np.float32)).cuda()
                    got = ops.walk_sample(*args, u, frac, base_log2=base_log2,
                                          **kw)
                    want = walk_sample_ref(*args, u, frac, base_log2=base_log2,
                                           **kw)
                    got_u = ops.walk_sample_uniform(args[3], args[4], u, **kw)
                    want_u = walk_sample_uniform_ref(args[3], args[4], u, **kw)
                    torch.cuda.synchronize()
                    what = (f"base 2^{base_log2}, fp={fp}, in_place={in_place}, "
                            f"u (B, {ncols})")
                    for name, g, x in (("walk_sample", got, want),
                                       ("walk_sample_uniform", got_u, want_u)):
                        need(all(torch.equal(a, b) for a, b in zip(g, x)),
                             f"{name} != plain ({what})")
                    n += 1
    return n


# (adaptive, fp_bias, base_log2): the update kernel's five config rows
UPDATE_CONFIGS = [(True, False, 1), (False, False, 1), (True, True, 1),
                  (True, False, 2), (True, True, 2)]
STREAMED_CAPACITIES = (37, 256, 300, 512)   # not a multiple of 32, the
                                            # main path's, past it, the
                                            # serving ladder's regrown width
ALIAS_KS = (1, 2, 5, 16, 17, 31, 32, 33, 63, 64)


def streamed_inputs(C, fp, seed):
    """The numpy inputs of ``streamed_state``: the graph ``(src, dst, w)``
    of 16 vertices (degrees 1..C/2, 6-bit biases) and a stream ``(ins, u,
    v, w)`` of single-edge updates: row 0 filled to C (two inserts
    rejected), row 1 emptied, row 2 a group 0 turned DENSE by an insert
    (its list left stale) and emptied by deletes (DENSE -> EMPTY keeps the
    list), row 3 a group 0 DENSE -> ONE (a rebuild), row 4 the same as row
    2 with a two-entry stale list, appended to once (ONE, an entry past
    gsize), then 60 random updates on rows 5-7.  Member bias 1 has digit 1
    in group 0 only; bias 0 is in no group; in fp mode a bias b is given
    as (b + 0.5) / 4 (lam 4), the same integer part."""
    V = 16
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, C // 2 + 1, V)
    src = np.repeat(np.arange(V), deg).astype(np.int32)
    dst = rng.integers(0, V, src.size).astype(np.int32)
    w = rng.integers(1, 64, src.size).astype(np.int32)
    nbr = [dst[src == r] for r in range(V)]
    seq = [(True, 0, 1000 + i, int(rng.integers(1, 60)))
           for i in range(C - deg[0] + 2)]
    for r in (1, 2, 3, 4):
        seq += [(False, r, int(x), 0) for x in nbr[r]]
    seq += [(True, 2, 50, 0), (True, 2, 51, 0), (True, 2, 52, 1),
            (True, 2, 53, 1)] + [(False, 2, 50 + i, 0) for i in range(4)]
    seq += [(True, 3, 60, 1), (True, 3, 61, 0), (True, 3, 62, 0)]
    seq += [(True, 4, 70 + i, int(i >= 3)) for i in range(6)]
    seq += [(False, 4, 70 + i, 0) for i in range(6)]
    seq += [(True, 4, 80 + i, 0) for i in range(3)] + [(True, 4, 90, 1)]
    for _ in range(60):
        r = int(rng.integers(5, 8))
        if rng.random() < 0.55:
            seq.append((True, r, int(rng.integers(0, 8)),
                        int(rng.choice([0, 1, 2, 3, 5, 7]))))
        else:
            seq.append((False, r, int(rng.integers(0, 8)), 0))
    ins, uu, vv, ww = (np.array(x) for x in zip(*seq))
    uu, vv = uu.astype(np.int32), vv.astype(np.int32)
    if fp:
        w = ((w + 0.5) / 4.0).astype(np.float32)
        ww = ((ww + 0.5) / 4.0).astype(np.float32)
    else:
        ww = ww.astype(np.int32)
    return (src, dst, w), (ins, uu, vv, ww)


def streamed_config(C, adaptive, fp, base_log2):
    """``streamed_state``'s configuration: its keyword arguments of
    ``BingoConfig``."""
    return dict(num_vertices=16, capacity=C, bias_bits=6, base_log2=base_log2,
                fp_bias=fp, lam=4.0, adaptive=adaptive)


def streamed_state(C, adaptive, fp, base_log2, seed, device="cuda"):
    """A state that went through ``stream_updates`` after ``from_edges``
    (``streamed_inputs``), and its config."""
    import torch
    from repro_torch.core import dyngraph as dg
    from repro_torch.core.updates import stream_updates
    cfg = dg.BingoConfig(**streamed_config(C, adaptive, fp, base_log2))
    graph, stream = streamed_inputs(C, fp, seed)
    st = dg.from_edges(cfg, *graph, device=device)
    st, _ = stream_updates(st, cfg, *[torch.from_numpy(x).to(device)
                                      for x in stream])
    return st, cfg


def stale_lists(st, cfg):
    """Whether ``streamed_state`` left what it promises: row 0 full, row
    1 empty, and (adaptive mode) member lists that gsize and gtype do not
    describe: row 2's EMPTY group 0 with an entry, row 4's ONE group 0
    with an entry past gsize."""
    from repro_torch.core import dyngraph as dg
    gm, gt, gs = (x.cpu().numpy() for x in (st.gmem, st.gtype, st.gsize))
    return (int(st.deg[0]) == cfg.capacity and int(st.deg[1]) == 0
            and (not cfg.adaptive
                 or (gt[2, 0] == dg.EMPTY and gm[2, 0, 0] >= 0
                     and gt[4, 0] == dg.ONE and gs[4, 0] == 1
                     and gm[4, 0, 1] >= 0)))


def alias_weights(rng, V, K):
    """Weight rows (V, K) for ``alias_build``: random rows, an all-zero
    row, single-entry rows (first and last entry), equal weights, and
    totals near the 1e-30 floor of the scaled weights."""
    w = (rng.random((V, K)) * rng.integers(1, 100, (V, K))).astype(np.float32)
    w[0] = 0.0
    w[1, 1:] = 0.0
    w[2, :-1] = 0.0
    w[3] = 7.0
    w[4] = 1e-30 / K
    w[5] = rng.random(K).astype(np.float32) * 1e-31
    w[6, ::2] = 1e-30
    return w


def check_update_kernel(rng):
    import torch
    from repro_torch.core import dyngraph as dg
    from repro_torch.core.updates import batched_update
    from repro_torch.kernels import ops
    n = 0

    def round_of(V, edges, Bn, mode, fp):
        ins = {"insert": np.ones(Bn, bool), "delete": np.zeros(Bn, bool),
               "mixed": rng.random(Bn) < 0.5}[mode]
        uu = rng.integers(0, V, Bn).astype(np.int32)
        vv = rng.integers(0, V, Bn).astype(np.int32)
        hit = ~ins & (rng.random(Bn) < 0.8)
        pick = rng.integers(0, len(edges[0]), Bn)
        uu[hit], vv[hit] = edges[0][pick[hit]], edges[1][pick[hit]]
        ww = rng.integers(1, 64, Bn).astype(np.int32)
        if fp:
            ww = ww.astype(np.float32) + rng.random(Bn).astype(np.float32)
        return [torch.from_numpy(x).cuda() for x in (ins, uu, vv, ww)]

    def compare(st_k, st_p, cfg, batch, what):
        st_p, s_p = batched_update(st_p, cfg, *batch)
        st_k, s_k = ops.update_fused(st_k, cfg, *batch)
        torch.cuda.synchronize()
        state_diff(st_p, st_k, what)
        for name, a, b in zip(s_p._fields[:4], s_p, s_k):
            need(torch.equal(a, b), f"update stats {name} differ ({what})")
        return st_k, st_p

    V, C, Bn = 4096, 64, 4096
    for adaptive, fp, base_log2 in UPDATE_CONFIGS:
        src, dst, w = random_graph(rng, V, C // 2, 6)
        wv = w.astype(np.float32) + rng.random(w.size).astype(np.float32) \
            if fp else w
        cfg = dg.BingoConfig(num_vertices=V, capacity=C, bias_bits=6,
                             adaptive=adaptive, fp_bias=fp,
                             base_log2=base_log2)
        for mode in ("insert", "delete", "mixed"):
            st_k = dg.from_edges(cfg, src, dst, wv, device="cuda")
            st_p = clone_state(st_k)
            for _ in range(2):
                st_k, st_p = compare(st_k, st_p, cfg,
                                     round_of(V, (src, dst), Bn, mode, fp),
                                     f"{mode}, adaptive={adaptive}, fp={fp}, "
                                     f"base 2^{base_log2}")
                n += 1
    # one batch much wider than 2·C, concentrated on a few rows
    V, C, Bn = 64, 8, 2048
    src, dst, w = random_graph(rng, V, C // 2, 5)
    cfg = dg.BingoConfig(num_vertices=V, capacity=C, bias_bits=5)
    st_k = dg.from_edges(cfg, src, dst, w, device="cuda")
    st_p = clone_state(st_k)
    batch = round_of(4, (src[src < 4], dst[src < 4]), Bn, "mixed", False)
    compare(st_k, st_p, cfg, batch, "B > 2C")
    n += 1
    # states that went through stream_updates (stale member lists, full
    # and emptied rows), then a round touching every streamed row; and
    # the prep kernels against plan_round's torch ops on the CPU
    from repro_torch.kernels.update_fused import plan_round
    for C in STREAMED_CAPACITIES:
        for adaptive, fp, base_log2 in UPDATE_CONFIGS:
            what = (f"after streaming, C={C}, adaptive={adaptive}, fp={fp}, "
                    f"base 2^{base_log2}")
            st_k, cfg = streamed_state(C, adaptive, fp, base_log2,
                                       seed=C + base_log2)
            need(stale_lists(st_k, cfg), f"{what}: not the streamed state "
                 "promised")
            nbr = st_k.nbr.cpu().numpy()
            live = nbr >= 0
            edges = (np.nonzero(live)[0].astype(np.int32), nbr[live])
            batch = round_of(16, edges, 64, "mixed", fp)
            batch[1][:24] = torch.arange(8, dtype=torch.int32,
                                         device="cuda").repeat_interleave(3)
            want = plan_round(cfg, *[x.cpu() for x in batch])
            got = plan_round(cfg, *batch)
            for f, a, b in zip(want._fields, got, want):
                need(a.dtype == b.dtype and torch.equal(a.cpu(), b),
                     f"{what}: plan_round field {f} != its torch ops")
            compare(st_k, clone_state(st_k), cfg, batch, what)
            n += 1
    return n


# degrees on both sides of the histogram kernel's 32-slot short rows (a
# lane a row up to 32, 8 lanes a row past it) and its 16-byte words
HIST_DEGREES = (0, 1, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65,
                127, 128, 129, 255, 256)


def hist_inputs(rng, V, C, K):
    """``radix_hist`` inputs on the card: (V, C) biases below 2^K (K = 32:
    every int32) and degrees 0..C, each of ``HIST_DEGREES`` below C and C
    itself in every lane position of a warp's 32 rows."""
    import torch
    bias = rng.integers(0, 1 << K, (V, C), dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    deg = rng.integers(0, C + 1, V).astype(np.int32)
    listed = np.array([x for x in HIST_DEGREES if x < C] + [C], np.int32)
    i = np.arange(32 * len(listed))
    deg[i] = listed[(i + i // 32) % len(listed)]
    return torch.from_numpy(bias).cuda(), torch.from_numpy(deg).cuda()


def check_table_kernels(rng):
    """``radix_hist`` and ``alias_build`` == their plain versions, bit for
    bit: K 4/16/31/32 × C 8/37/256 on ``hist_inputs``' 4,097 rows; K over
    ``ALIAS_KS`` on ``alias_weights``' rows, 4,097 of them (a last warp
    part full)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.alias_build import alias_build_ref
    from repro_torch.kernels.radix_hist import radix_hist_ref
    V, n = 4096, 0
    for K in (4, 16, 31, 32):
        for C in (8, 37, 256):
            bias, deg = hist_inputs(rng, V + 1, C, K)
            got = ops.radix_hist(bias, deg, num_k=K)
            want = radix_hist_ref(bias, deg, K)
            torch.cuda.synchronize()
            need(all(torch.equal(a, b) for a, b in zip(got, want)),
                 f"radix_hist != plain (K={K}, C={C})")
            n += 1
    for K in ALIAS_KS:
        w = torch.from_numpy(alias_weights(rng, V + 1, K)).cuda()
        got = ops.alias_build(w)
        want = alias_build_ref(w)
        torch.cuda.synchronize()
        need(all(torch.equal(a, b) for a, b in zip(got, want)),
             f"alias_build != plain (K={K})")
        n += 1
    return n


def flash_excess(got, want, dtype):
    """Largest ``|got - want| / (atol + rtol * |want|)`` over the entries,
    at ``FLASH_TOL[dtype]``: the limit holds where it is at most 1."""
    atol, rtol = FLASH_TOL[dtype]
    want = want.float()
    return float(((got.float() - want).abs() / (atol + rtol * want.abs())).max())


def flash_row_excess(got, plain, ref32):
    """Largest share of the bf16 limit ``FLASH_ROW`` over the query rows:
    ``max_d |got - ref32|`` over ``k * max_d |plain - ref32| + step *
    max_d |ref32|``; the limit holds where it is at most 1."""
    k, step = FLASH_ROW
    r = ref32.float()
    err = (got.float() - r).abs().amax(-1)
    lim = k * (plain.float() - r).abs().amax(-1) + step * r.abs().amax(-1)
    return float((err / lim.clamp_min(1e-30)).max())


def flash_refs(q, k, v, causal, window):
    """``(plain, ref32)``: the plain version of the kernel of q's type and,
    for bfloat16 and float16, the all-float32 algorithm (None for
    float32)."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_ref,
                                                     flash_attention_ref32)
    plain = flash_attention_ref(q, k, v, causal=causal, window=window)
    ref32 = flash_attention_ref32(q, k, v, causal=causal, window=window) \
        if q.dtype != torch.float32 else None
    return plain, ref32


def flash_limit(got, plain, ref32):
    """Share of its limit that ``got`` reaches: entry by entry at
    ``FLASH_TOL`` against the plain version in float32 (``ref32`` None),
    row by row at ``FLASH_ROW`` against ``ref32`` in 16 bits."""
    if ref32 is None:
        return flash_excess(got, plain, "float32")
    return flash_row_excess(got, plain, ref32)


def flash_route(dtype):
    """The launch counter of the kernel that takes ``dtype`` (a
    ``FLASH_CASES`` type name)."""
    return "flash_attention" if dtype == "float32" else "flash_attention_sm90"


def shifted_window(T, window):
    """The window of a planted fault: the band's lower edge one 64-key tile
    off (``window + 64``) or, with no window, the first tile cut from the
    last rows (``T - 64``).  The limit must reject its output."""
    return window + 64 if window else T - 64


def flash_inputs(case, seed):
    """q, k and v of a ``FLASH_CASES`` entry on the card, from ``seed``."""
    import torch
    B, H, Hkv, S, T, D, dtype, _, _ = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device="cuda").to(
        getattr(torch, dtype)) for shape in
        ((B, H, S, D), (B, Hkv, T, D), (B, Hkv, T, D)))


def check_flash_kernel(rng):
    """``flash_attention`` over ``FLASH_CASES``, each case through the
    kernel of its type (the launch counters show which), held at its limit
    (``flash_limit``), and a planted fault (the kernel at
    ``shifted_window``) against the same limit, which must reject it.
    Returns, per case, the max abs difference from the plain version, the
    share of the limit, the fault's two, and in bf16 the readings of the
    old entry-by-entry ``FLASH_TOL`` (kernel, fault) against the plain
    version."""
    import torch
    from repro_torch.kernels import ops
    errs = []
    for case in FLASH_CASES:
        B, H, Hkv, S, T, D, dtype, causal, window = case
        q, k, v = flash_inputs(case, int(rng.integers(2**31)))
        route = flash_route(dtype)
        before = ops.launch_counts()
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        fault = ops.flash_attention(q, k, v, causal=causal,
                                    window=shifted_window(T, window))
        after = ops.launch_counts()
        need(after[route] == before[route] + 2
             and sum(after.values()) == sum(before.values()) + 2,
             f"flash_attention ({case}): launches {before} -> {after}")
        plain, ref32 = flash_refs(q, k, v, causal, window)
        err = float((got.float() - plain.float()).abs().max())
        fault_err = float((fault.float() - plain.float()).abs().max())
        excess = flash_limit(got, plain, ref32)
        fault_excess = flash_limit(fault, plain, ref32)
        need(got.dtype == q.dtype and bool(torch.isfinite(got).all())
             and excess <= 1,
             f"flash_attention != plain ({case}): max abs {err}, "
             f"{excess:.3f} of the limit")
        need(fault_excess > 1, f"flash_attention ({case}): the limit passes a "
             f"kernel one tile off ({fault_excess:.3f} of it)")
        old = None if dtype != "bfloat16" else (
            flash_excess(got, plain, dtype), flash_excess(fault, plain, dtype))
        errs.append({"case": list(case), "max_abs_err": err, "excess": excess,
                     "fault_max_abs_err": fault_err,
                     "fault_excess": fault_excess, "old_tol_excess": old})
    return errs


def kernel_resources(name):
    """Per kernel function of the library of ``csrc/<name>.cu``: ptxas's
    registers, stack frame and spill stores (from this run's build log;
    from ``cuobjdump -res-usage``'s REG, STACK and LOCAL when the library
    was built before), in the order ptxas reports them."""
    import re
    from repro_torch.kernels import _build
    log = _build.BUILD_LOG.get(name)
    if log is not None:
        out, fn = [], None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                fn = {"function": m.group(1)}
                out.append(fn)
            elif fn is not None and "spill stores" in line:
                fn["spill_stores"] = int(re.search(r"(\d+) bytes spill stores",
                                                   line).group(1))
                fn["stack"] = int(re.search(r"(\d+) bytes stack frame",
                                            line).group(1))
            elif fn is not None and "Used" in line and "registers" in line:
                fn["registers"] = int(re.search(r"Used (\d+) registers",
                                                line).group(1))
        return out
    res = subprocess.run(
        [str(Path(_build._nvcc()).parent / "cuobjdump"), "-res-usage",
         str(_build._lib_path(name))], capture_output=True, text=True,
        timeout=300, check=True).stdout
    return [{"function": f, "registers": int(r), "stack": int(sk),
             "spill_stores": int(lo)}
            for f, r, sk, lo in re.findall(
                r"Function ([^:\s]+):\s*REG:(\d+) STACK:(\d+) SHARED:\d+ "
                r"LOCAL:(\d+)", res)]


def table_census():
    """Every kernel function of ``update_fused.cu`` (the round and its two
    prep kernels and the mark of U), ``alias_build.cu`` (its row widths)
    and ``radix_hist.cu``: registers, stack frame and spill stores
    (``kernel_resources``); no stack and no spills, so nothing of the
    warp-wide Vose row or of the histogram's bit planes and 16-byte row
    words lives in local memory."""
    out = {}
    for name in ("update_fused", "alias_build", "radix_hist"):
        res = kernel_resources(name)
        for x in res:
            print(f"{name} census: {x['function'][-60:]}: "
                  f"{x.get('registers')} registers, {x.get('stack')} bytes "
                  f"stack, {x.get('spill_stores')} bytes spill stores",
                  flush=True)
        need(res and all(x.get("stack") == 0 and x.get("spill_stores") == 0
                         for x in res), f"{name}: stack or spills {res}")
        out[name] = res
    return out


def attention_instance(function):
    """A short name of an attention kernel's mangled name: the kernel and
    its template arguments (``flash_attention_slice_kernel<256>``,
    ``flash_attention_sm90_kernel<bf16,512,256>``)."""
    import re
    m = re.search(r"(flash_attention\w*_kernel)I(.*?)EEv", function)
    if m is None:
        return function
    args = (["bf16"] if "bfloat16" in m.group(2) else
            ["f16"] if "half" in m.group(2) else []) + \
        re.findall(r"Li(\d+)E", m.group(2) + "E")
    return f"{m.group(1)}<{','.join(args)}>"


def sm90_census():
    """What nvcc made of the two attention libraries (bf16 and f16
    ``flash_attention_sm90``, f32 ``flash_attention``): per instantiation,
    registers and spill stores (``kernel_resources``), all spills 0; and
    in ``cuobjdump -sass`` of each kernel function the count of HGMMA
    (wgmma) and UTMALDG (TMA load) instructions: every instantiation on
    the tensor cores with TMA loads."""
    import re
    from repro_torch.kernels import _build
    out = {}
    for name in ("flash_attention_sm90", "flash_attention"):
        res = kernel_resources(name)
        sass = subprocess.run(
            [str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass",
             str(_build._lib_path(name))],
            capture_output=True, text=True, timeout=300, check=True).stdout
        parts = re.split(r"\n\s*Function : (\S+)", sass)
        functions = {attention_instance(f): {"HGMMA": body.count("HGMMA"),
                                             "UTMALDG": body.count("UTMALDG")}
                     for f, body in zip(parts[1::2], parts[2::2])}
        for x in res:
            functions.setdefault(attention_instance(x["function"]), {}).update(
                registers=x.get("registers"),
                spill_stores=x.get("spill_stores"))
        census = {"functions": functions,
                  "HGMMA": sass.count("HGMMA"), "HMMA": sass.count("HMMA"),
                  "UTMALDG": sass.count("UTMALDG")}
        for f, c in functions.items():
            print(f"{name} census: {f}: {c}", flush=True)
        need(res and all(x.get("spill_stores") == 0 for x in res),
             f"{name}: spill stores {census}")
        need(functions and all(c.get("HGMMA", 0) > 0 and c.get("UTMALDG", 0) > 0
                               for c in functions.values()),
             f"{name}: a kernel without a tensor-core instruction or a TMA "
             f"load in its SASS {census}")
        out[name] = census
    return out


def walk_census():
    """The walk kernels' six instantiations (whole walk and segment, each
    a tile of lanes a biased walker and a thread a simple one; the per-step
    sample and uniform pick): registers and spill stores
    (``kernel_resources``), no spills; and the resident blocks of 256
    threads per SM (the libraries' occupancy entries, what the persistent
    grids are sized by), as warps and as a share of the SM's 64.  The
    segment's preparation kernel (``segment_prep_kernel``) is not counted
    here."""
    import re
    from repro_torch.kernels import _build
    fused, sample = _build.library("walk_fused"), _build.library("walk_sample")
    rows = []
    for name in ("walk_fused", "walk_sample"):
        for x in kernel_resources(name):
            f = x["function"]
            m = re.search(r"walk_fused_kernelILb(\d)ELi(\d+)E", f)
            if m:
                seg, lanes = int(m.group(1)), int(m.group(2))
                label = (f"walk_fused<{'segment' if seg else 'whole'}, "
                         f"{lanes} lane{'s' if lanes > 1 else ''}>")
                blocks = fused.walk_fused_occupancy(seg, int(lanes == 1))
            elif "walk_sample_kernel" in f:
                label, blocks = "walk_sample", sample.walk_sample_occupancy()
            elif "walk_sample_uniform_kernel" in f:
                label, blocks = "walk_sample_uniform", None
            else:
                continue
            rows.append(dict(x, kernel=label, blocks_per_sm=blocks,
                             warps_per_sm=None if blocks is None else 8 * blocks,
                             occupancy=None if blocks is None else blocks / 8))
    for r in rows:
        occ = "" if r["blocks_per_sm"] is None else (
            f", {r['blocks_per_sm']} blocks/SM = {r['warps_per_sm']} warps "
            f"({100 * r['occupancy']:.1f} % of 64)")
        print(f"walk census: {r['kernel']}: {r.get('registers')} registers, "
              f"{r.get('spill_stores')} bytes spill stores{occ}", flush=True)
    need(len(rows) == 6 and all(r.get("spill_stores") == 0 for r in rows),
         f"walk kernels: census {rows}")
    return rows


# ---------------------------------------------------------------- phase 3
def check_paths(name, p, st, starts, cfg):
    """A walk batch is real: column 0 equals the starts, vertices in range,
    no walker revives after -1, and every hop of the first
    ``CHECK_WALKERS`` walkers is an edge of ``st``."""
    import torch
    V = cfg.num_vertices
    need(tuple(p.shape) == (len(starts), p.shape[1]), f"{name}: path shape")
    need(torch.equal(p[:, 0], starts), f"{name}: column 0 != starts")
    need(bool(((p >= -1) & (p < V)).all()), f"{name}: vertex out of range")
    dead = p[:, :-1] < 0
    need(not bool((dead & (p[:, 1:] >= 0)).any()), f"{name}: revived walker")
    a, b = p[:CHECK_WALKERS, :-1].long(), p[:CHECK_WALKERS, 1:].long()
    hop = (a >= 0) & (b >= 0)
    rows = st.nbr[a[hop]]
    ok = ((rows == b[hop][:, None])
          & (torch.arange(cfg.capacity, device=p.device)[None, :]
             < st.deg[a[hop]][:, None])).any(1)
    need(bool(ok.all()), f"{name}: a hop that is not an edge")


def tv_bound(probs, n, delta=1e-6):
    """A TV distance a correct sampler exceeds with probability < delta at
    ``n`` samples: E[TV] <= ½ Σ sqrt(p(1-p)/n), plus McDiarmid's
    sqrt(ln(1/delta) / 2n) (one sample moves TV by at most 1/n)."""
    import torch
    p = probs[probs > 0].double()
    return (0.5 * float(torch.sqrt(p * (1 - p) / n).sum())
            + math.sqrt(math.log(1 / delta) / (2 * n)))


def check_distribution(name, nxt, want, V):
    """TV of the empirical next-vertex distribution of ``nxt`` against
    ``want`` (V,), within ``tv_bound``; returns ``(tv, bound, n)``."""
    import torch
    n = nxt.numel()
    need(n > 0, f"{name}: no samples")
    emp = torch.bincount(nxt, minlength=V).double() / n
    tv = 0.5 * float((emp - want.double()).abs().sum())
    b = tv_bound(want, n)
    print(f"{name}: TV {tv:.4f} over {n} samples, bound {b:.4f}", flush=True)
    need(tv < b, f"{name}: TV {tv:.4f} >= bound {b:.4f}")
    return {"tv": tv, "tv_bound": b, "samples": n}


def walk_work(path, deg, uniform):
    """The work this run's walks need, each input word read once.

    A step is drawn at every live column t < L; it reads ``deg[cur]`` and,
    when the walker moves on, one prob and one alias entry and the bias
    row ``bias[cur, 0:deg]`` (the group's members are found by their
    digits: two operations per bias word), and the picked nbr word.
    Counted over distinct vertices (deg, prob/alias, bias rows) and
    distinct (vertex, next) hops (nbr words), plus the starts read and the
    (B, L+1) path written.  ``step_bytes`` is what the steps read if no
    row were ever reused from cache: 32-byte sectors for each scattered
    word, the bias row in sectors, per step.
    """
    import torch
    B, L1 = path.shape
    cur, nxt = path[:, :-1].long(), path[:, 1:].long()
    drawn, moved = cur >= 0, nxt >= 0
    x_drawn = torch.unique(cur[drawn])
    x_moved = torch.unique(cur[moved])
    hops = torch.unique(cur[moved] * deg.shape[0] + nxt[moved]).numel()
    d_moved = deg[cur[moved]].long()
    words = B + B * L1 + x_drawn.numel() + hops
    steps, moves = int(drawn.sum()), int(moved.sum())
    sectors = steps + moves                        # deg, nbr
    ops = 0
    if not uniform:
        words += 2 * x_moved.numel() + int(deg[x_moved].long().sum())
        sectors += 2 * moves + int(((d_moved + 7) // 8).sum())
        ops = 2 * int(d_moved.sum())
    return {"bytes": 4 * words, "ops": ops, "alive_steps": steps,
            "moves": moves, "distinct_rows": x_moved.numel(),
            "step_bytes": 32 * sectors + 4 * (B + B * L1)}


def update_work(plan, old, new, cfg):
    """The work the round needs, each word read or written once.

    Per affected row: read deg and the nbr/bias (and, in fp mode, frac)
    slots below the old degree; write deg and those rows below
    max(old, new degree); write each group's member list up to the
    larger of its old and new kept length (ginv below max degree in
    baseline mode); write the O(K) counters and the Kin alias row.  Per
    lane the kernel reads its sorted insert or delete lane (value and
    rank); per row its five segment words.  Operations: the
    rebuild's digit extract, test and add per group and slot, one compare
    per delete lane and slot, Kin^2 Vose steps.
    """
    import torch
    from repro_torch.core.dyngraph import DENSE
    V, C, K, Cg, Kin = (cfg.num_vertices, cfg.capacity, cfg.num_radix,
                        cfg.group_capacity, cfg.num_inter)
    real = plan.U < V
    U = plan.U[real].long()
    d0, d1 = old.deg[U].long(), new.deg[U].long()
    dmax = torch.maximum(d0, d1)
    cols = 3 if cfg.fp_bias else 2               # nbr, bias (, frac)

    def kept(st):
        gs = st.gsize[U].long().clamp(max=Cg)
        return gs.masked_fill(st.gtype[U] == DENSE, 0) if cfg.adaptive else gs

    n_ins = (plan.ins_hi - plan.ins_lo)[real].long()
    n_del = (plan.del_hi - plan.del_lo)[real].long()
    rows = U.numel()
    words = (2 * rows + cols * int(d0.sum()) + cols * int(dmax.sum())
             + int(torch.maximum(kept(old), kept(new)).sum())
             + (0 if cfg.adaptive else K * int(dmax.sum()))
             + rows * (2 * K + 1 + 2 * Kin) + 5 * rows
             + cols * int(n_ins.sum()) + 2 * int(n_del.sum()))
    nbytes = 4 * words + rows * K                                  # gtype
    post = (d0 + n_ins).clamp(max=C)
    ops = (3 * K * int(d1.sum()) + int((n_del * post).sum())
           + rows * Kin * Kin)
    return {"bytes": nbytes, "ops": ops, "affected_rows": rows}


def main_path(args, report):
    import torch
    from repro_torch.core import dyngraph as dg
    from repro_torch.core.updates import batched_update
    from repro_torch.core.walks import WalkParams, ppr, random_walk
    from repro_torch.graph.rmat import degree_bias, rmat_edges
    from repro_torch.graph.streams import make_update_stream
    from repro_torch.kernels import ops
    from repro_torch.kernels.update_fused import launch_round, plan_round
    from repro_torch.kernels.walk_fused import walk_fused_ref
    from repro_torch.serve import DynamicWalkEngine

    scale, rounds = args.scale, 10
    V = 1 << scale
    t0 = time.perf_counter()
    src, dst = rmat_edges(scale, 8, seed=0)
    w = degree_bias(src, dst, V, bias_bits=16)
    batch = min(100_000, len(src) // (4 * rounds))
    stream = make_update_stream(src, dst, w, batch_size=batch, rounds=rounds,
                                mode="mixed", seed=0)
    report["host_data_s"] = time.perf_counter() - t0
    cfg = dg.BingoConfig(num_vertices=V, capacity=256, bias_bits=16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = dg.from_edges(cfg, stream.init_src, stream.init_dst,
                          stream.init_w, device="cuda")
    torch.cuda.synchronize()
    report["from_edges_s"] = time.perf_counter() - t0
    report["state_gib"] = sum(
        x.numel() * x.element_size() for x in
        [state.nbr, state.bias, state.frac, state.deg, state.gmem,
         state.gsize, state.digitsum, state.wdec, state.gtype,
         state.itable.prob, state.itable.alias]) / 2**30
    print(f"main path: V=2^{scale}, {len(stream.init_src)} initial edges, "
          f"{rounds} rounds x {batch} updates, state "
          f"{report['state_gib']:.2f} GiB, from_edges "
          f"{report['from_edges_s']:.2f} s", flush=True)

    def dev_round(r):
        return [torch.from_numpy(np.ascontiguousarray(a[r])).cuda()
                for a in (stream.is_insert, stream.u, stream.v, stream.w)]

    # round 1 through the plain version, on a copy
    plain1, _ = batched_update(clone_state(state), cfg, *dev_round(0))
    engine = DynamicWalkEngine(state, cfg, WalkParams("deepwalk", WALK_LEN),
                               seed=0)
    starts = torch.arange(0, V, 4, dtype=torch.int32, device="cuda")
    pre_last = None
    round_ms = []
    round_stats = []
    applied = 0
    upd_err = 0.0
    ops.reset_launch_counts()
    plan_round.launches = 0
    torch.cuda.synchronize()
    t_main = time.perf_counter()
    t_r = t_main
    for r, stats, paths in engine.run_stream(stream, starts):
        torch.cuda.synchronize()
        now = time.perf_counter()
        round_ms.append((now - t_r) * 1e3)
        need(int(stats.ins_applied) + int(stats.del_applied)
             + int(stats.rejected.sum()) == batch,
             f"round {r}: applied + rejected != {batch}")
        need(int(stats.rejected[1]) == 0, f"round {r}: vertex rejects")
        applied += int(stats.ins_applied) + int(stats.del_applied)
        round_stats.append(stats_list(stats))
        need(tuple(paths.shape) == (len(starts), WALK_LEN + 1),
             f"round {r}: path shape {tuple(paths.shape)}")
        if r == 0:
            upd_err = state_diff(plain1, engine.state, "round 1 vs batched_update")
            del plain1
        if r == rounds - 2:
            pre_last = clone_state(engine.state)
        last_paths, last_seed = paths, engine.last_seed
        torch.cuda.synchronize()
        t_r = time.perf_counter()
    t_stream = time.perf_counter() - t_main
    ppr_paths = ppr(engine.state, cfg, starts, 1234, max_length=PPR_LEN,
                    stop_prob=PPR_STOP)
    simple_paths = random_walk(engine.state, cfg, starts, 4321,
                               WalkParams("simple", WALK_LEN))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    report["launches"] = counts
    print(f"main path launches: {counts}; update prep kernels (plan_round) "
          f"{plan_round.launches} rounds", flush=True)
    need(counts["update_fused"] == rounds, "update_fused launches != rounds")
    need(plan_round.launches == rounds, "plan_round's kernels != rounds")
    need(counts["walk_fused"] == rounds + 2, "walk_fused launches != walks")

    # outputs: the paths are real walks on the current state
    st = engine.state
    for name, p in (("deepwalk", last_paths), ("ppr", ppr_paths),
                    ("simple", simple_paths)):
        check_paths(name, p, st, starts, cfg)
    ppr_len = float((ppr_paths[:, 1:] >= 0).sum(1).float().mean())
    report.update(round_ms=round_ms, round_stats=round_stats,
                  round_median_ms=statistics.median(round_ms),
                  round_mean_ms=statistics.mean(round_ms), stream_s=t_stream,
                  updates_applied=applied, ppr_mean_hops=ppr_len)
    print(f"run_stream: {t_stream:.3f} s for {rounds} rounds (per round ms "
          f"{[round(x, 2) for x in round_ms]}; median "
          f"{report['round_median_ms']:.2f}, mean {report['round_mean_ms']:.2f}); "
          f"ppr mean hops {ppr_len:.2f}", flush=True)

    # ---- phase 4: times at the main path's shapes; the plain versions'
    # outputs are held against the main path's, whole batches
    args_w = (st.itable.prob, st.itable.alias, st.bias, st.nbr, st.deg, None,
              starts)
    walks = {}
    for kind, got, seed, kw in (
            ("deepwalk", last_paths, last_seed, dict(length=WALK_LEN)),
            ("ppr", ppr_paths, 1234, dict(length=PPR_LEN, stop_prob=PPR_STOP)),
            ("simple", simple_paths, 4321, dict(length=WALK_LEN, uniform=True))):
        ms, _ = cuda_ms(lambda: ops.walk_fused(*args_w, seed, **kw))
        plain_ms, want = cuda_ms(lambda: walk_fused_ref(*args_w, seed=seed,
                                                        **kw), reps=1)
        err = path_diff(got, want, f"main path {kind}")
        del want
        work = walk_work(got, st.deg, kind == "simple")
        b_ms, b_by = bound(work["bytes"], work["ops"])
        walks[kind] = dict(work, ms=ms, plain_ms=plain_ms, max_abs_err=err,
                           bound_ms=b_ms, bound_by=b_by,
                           step_bytes_ms=work["step_bytes"] / hw.HBM_BW * 1e3,
                           steps_per_s=work["alive_steps"] / ms * 1e3)
        print(f"walk_fused {kind}: {ms:.3f} ms, {work['alive_steps']} alive "
              f"steps ({work['alive_steps'] / ms / 1e3:.1f} M steps/s); "
              f"plain {plain_ms:.1f} ms, equal on all {len(starts)} walkers; "
              f"needs {work['bytes'] / 1e9:.4f} GB over {work['distinct_rows']} "
              f"distinct rows and {work['ops'] / 1e9:.3f} G ops -> bound "
              f"{b_ms:.4f} ms ({b_by}); per-step bytes with no reuse "
              f"{work['step_bytes'] / 1e9:.3f} GB -> "
              f"{walks[kind]['step_bytes_ms']:.3f} ms", flush=True)

    last = dev_round(rounds - 1)
    plan = plan_round(cfg, *last)
    plain_plan = plan_round(cfg, *[x.cpu() for x in last])
    for f, a, b in zip(plan._fields, plan, plain_plan):
        need(a.dtype == b.dtype and torch.equal(a.cpu(), b),
             f"round 10: plan_round field {f} != its torch ops")
    del plain_plan
    plan_ms, _ = cuda_ms(lambda: plan_round(cfg, *last))
    upd_ms, _ = cuda_ms(lambda s: launch_round(s, cfg, plan),
                        setup=lambda: clone_state(pre_last))
    round_wrapper_ms, _ = cuda_ms(lambda s: ops.update_fused(s, cfg, *last),
                                  setup=lambda: clone_state(pre_last))
    upd_plain_ms, (plain_last, _) = cuda_ms(
        lambda s: batched_update(s, cfg, *last), reps=1,
        setup=lambda: clone_state(pre_last))
    upd_err = max(upd_err, state_diff(plain_last, st, "round 10 vs batched_update"))
    del plain_last
    no_sync_round(pre_last, cfg, last, st, round_stats[-1])
    uwork = update_work(plan, pre_last, st, cfg)
    u_ms, u_by = bound(uwork["bytes"], uwork["ops"])
    dw = walks["deepwalk"]
    kernels = [
        {"name": "walk_fused", "route": "cuda",
         "source": "src/repro_torch/csrc/walk_fused.cu",
         "replaces": "src/repro/kernels/walk_fused.py:444",
         "launches": counts["walk_fused"],
         "max_abs_err": max(w["max_abs_err"] for w in walks.values()),
         "ms": dw["ms"], "plain_ms": dw["plain_ms"],
         "bound_ms": dw["bound_ms"], "bound_by": dw["bound_by"],
         "library_ms": None},
        {"name": "update_fused", "route": "cuda",
         "source": "src/repro_torch/csrc/update_fused.cu",
         "replaces": "src/repro/kernels/update_fused.py:452",
         "launches": counts["update_fused"], "max_abs_err": upd_err,
         "ms": upd_ms, "plain_ms": upd_plain_ms,
         "bound_ms": u_ms, "bound_by": u_by, "library_ms": None},
    ]
    report.update(
        walks=walks,
        update=dict(uwork, kernel_ms=upd_ms, round_ms=round_wrapper_ms,
                    plan_ms=plan_ms,
                    plain_ms=upd_plain_ms, bound_ms=u_ms, bound_by=u_by,
                    batch=batch, updates_per_s=batch / round_wrapper_ms * 1e3),
        kernels=kernels)
    print(f"update_fused: kernel {upd_ms:.4f} ms, prepass (plan_round) "
          f"{plan_ms:.4f} ms, whole round "
          f"{round_wrapper_ms:.4f} ms ({batch / round_wrapper_ms * 1e3:.0f} "
          f"updates/s), {uwork['affected_rows']} rows; plain {upd_plain_ms:.1f} "
          f"ms, states equal after rounds 1 and 10 (and the prepass to its "
          f"torch ops); needs "
          f"{uwork['bytes'] / 1e9:.4f} GB and {uwork['ops'] / 1e9:.3f} G ops "
          f"-> bound {u_ms:.4f} ms ({u_by})", flush=True)
    profile = None
    if args.profile:
        def profile():
            try:    # a diagnostic: a profiler fault does not fail the smoke
                report["profile"] = profile_round(pre_last, cfg, last, starts,
                                                  args.profile)
            except Exception as e:          # noqa: BLE001
                traceback.print_exc()
                print(f"profiled round: failed ({e!r})", flush=True)
                report["profile"] = {"error": repr(e)}
    return kernels, engine, cfg, starts, stream, (src, dst, w), profile


def no_sync_round(pre, cfg, lanes, want, want_stats):
    """The main path's last round once more through ``ops.update_fused``
    under ``torch.cuda.set_sync_debug_mode("error")``: any host sync in
    the round raises; its state and stats must equal the main path's."""
    import torch
    from repro_torch.kernels import ops
    st = clone_state(pre)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, stats = ops.update_fused(st, cfg, *lanes)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    state_diff(want, st, "round 10 under sync debug mode")
    need(stats_list(stats) == want_stats,
         "round 10 under sync debug mode: stats != the main path's")
    print("update_fused: round 10 again under set_sync_debug_mode('error'): "
          "no host sync, state and stats equal", flush=True)


def stats_list(stats):
    """An ``UpdateStats``' counters as nested lists (JSON)."""
    return [x.tolist() for x in stats[:4]]


# --------------------------------------------------------------- phase 3d
def degree_histogram(deg, C):
    """Rows by degree (clamped to C): 0, 1-8, 9-32 (``radix_hist.cu``
    counts a row up to 32 in its own lane), 33 to C-1 (8 lanes a row) and
    C (full rows)."""
    d = deg.clamp(min=0, max=C)
    return {f"{lo}-{hi}" if lo < hi else str(lo): int(((d >= lo) & (d <= hi)).sum())
            for lo, hi in ((0, 0), (1, 8), (9, 32), (33, C - 1), (C, C))}


def table_phase(engine, cfg, report):
    """Phase 3d: ``radix_hist`` and ``alias_build`` on the main path's
    final state, through ``ops``, the counters zeroed just before and read
    just after; their outputs and the plain versions' must equal the
    tables the state keeps.  Returns the two kernels' lines."""
    import torch
    from repro_torch.core.radix import group_weights
    from repro_torch.kernels import ops
    from repro_torch.kernels.alias_build import alias_build_ref
    from repro_torch.kernels.radix_hist import radix_hist_ref
    st = engine.state
    need(not cfg.fp_bias and cfg.base_log2 == 1,
         "phase 3d expects a base-2 integer state")
    K = cfg.num_radix
    V, C = st.bias.shape
    gw = group_weights(st.digitsum, cfg.base_log2)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ds, gs = ops.radix_hist(st.bias, st.deg, num_k=K)
    prob, alias = ops.alias_build(gw)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"tables on the final state, launches: {counts}", flush=True)
    need(counts["radix_hist"] == counts["alias_build"] == 1
         and sum(counts.values()) == 2, f"phase 3d launches {counts}")

    def same_hist(got, what):
        need(torch.equal(got[0], st.digitsum) and torch.equal(got[1], st.gsize),
             f"{what} on the final state != (digitsum, gsize)")

    def same_itable(got, what):
        need(torch.equal(got[0], st.itable.prob)
             and torch.equal(got[1], st.itable.alias),
             f"{what} on the final state != state.itable")

    same_hist((ds, gs), "radix_hist")
    same_itable((prob, alias), "alias_build")
    del ds, gs, prob, alias
    hist = degree_histogram(st.deg, C)
    report["degree_histogram"] = hist
    print(f"rows by degree on the final state: {hist}", flush=True)
    edges = int(st.deg.clamp(max=C).sum())
    lines = []
    for name, fn, ref, same, nbytes, nops, replaces in (
            ("alias_build", lambda: ops.alias_build(gw),
             lambda: alias_build_ref(gw), same_itable, 4 * 3 * V * K,
             V * (K * K + 3 * K), "src/repro/kernels/alias_build.py:67"),
            ("radix_hist", lambda: ops.radix_hist(st.bias, st.deg, num_k=K),
             lambda: radix_hist_ref(st.bias, st.deg, K), same_hist,
             4 * (V + edges + 2 * V * K), 4 * K * edges,
             "src/repro/kernels/radix_hist.py:48")):
        ms, got = cuda_ms(fn)
        same(got, name)
        plain_ms, want = cuda_ms(ref, reps=1)
        same(want, f"{name} plain")
        del got, want
        b_ms, b_by = bound(nbytes, nops)
        report[name] = {"ms": ms, "plain_ms": plain_ms, "bytes": nbytes,
                        "ops": nops, "bound_ms": b_ms, "bound_by": b_by,
                        "launches": counts[name], "edges": edges}
        print(f"{name}: {ms:.4f} ms on the final state ({V} rows, K={K}, "
              f"{edges} edges); plain {plain_ms:.2f} ms; both equal to the "
              f"state's tables; needs {nbytes / 1e6:.1f} MB and "
              f"{nops / 1e6:.1f} M ops -> bound {b_ms:.4f} ms ({b_by})",
              flush=True)
        lines.append({"name": name, "route": "cuda",
                      "source": f"src/repro_torch/csrc/{name}.cu",
                      "replaces": replaces, "launches": counts[name],
                      "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    return lines


# --------------------------------------------------------------- phase 3b
def sample_work(rows, nxt, deg, ucols, uniform):
    """The work one per-step sample of every walker needs, each word read
    once, counted as ``walk_work`` counts a step: per distinct row its deg
    word and, for the biased sample of a row with edges, one prob and one
    alias entry and its bias row (deg words, two operations each); one
    nbr word per distinct (row, next) hop; the rows and ``ucols`` uniform
    columns read and the (nxt, slot) pair written per walker."""
    import torch
    r = rows.long()
    B, V = r.numel(), deg.shape[0]
    live = nxt >= 0
    words = (torch.unique(r).numel()
             + torch.unique(r[live] * V + nxt[live].long()).numel()
             + B * (1 + ucols + 2))
    ops = 0
    if not uniform:
        d = deg[r].long()
        xm = torch.unique(r[d > 0])
        words += 2 * xm.numel() + int(deg[xm].long().sum())
        ops = 2 * int(d.sum())
    return {"bytes": 4 * words, "ops": ops, "walkers": B}


def n2v_probs(st, cfg, prev, cur, p, q):
    """Exact node2vec P(v | prev, cur) ∝ w(cur, v)·f(prev, v) by vertex:
    f = 1/p for v == prev, 1 for v ∈ N(prev), 1/q otherwise (Eq. 1)."""
    import torch
    d, dp = int(st.deg[cur]), int(st.deg[prev])
    nb = st.nbr[cur, :d].long()
    w = st.bias[cur, :d].float() + st.frac[cur, :d]
    f = torch.where(nb == prev, 1.0 / p,
                    torch.where(torch.isin(nb, st.nbr[prev, :dp].long()),
                                1.0, 1.0 / q))
    probs = torch.zeros(cfg.num_vertices, dtype=torch.float64,
                        device=nb.device).index_add_(0, nb, (w * f).double())
    return probs / probs.sum()


def first_order_probs(st, cfg, v):
    """Eq. 2 next-vertex distribution out of ``v`` (``transition_probs``)."""
    import torch
    from repro_torch.core.sampler import transition_probs
    d = int(st.deg[v])
    p = transition_probs(st, cfg, torch.tensor([v], device=st.deg.device))[0]
    return torch.zeros(cfg.num_vertices, dtype=torch.float64,
                       device=p.device).index_add_(
        0, st.nbr[v, :d].long(), p[:d].double())


def launch_events(runs, trace):
    """Run each ``(fn, kernel)`` of ``runs`` once, in order, in one
    ``torch.profiler`` session (device activity only), each ``ops.<kernel>``
    call (``walk_sample`` or ``walk_sample_uniform``: the per-step paths
    reach the kernels through them) counting its walkers.  Returns, a run
    each, the walkers of its launches and the device ms of the trace's
    ``<kernel>_kernel`` events that fall to it: a kernel's events in time
    order, handed out to its runs by their launch counts (each run is
    synchronized before the next starts).  Checks nothing: a trace may
    hold fewer events than launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    walkers = [[] for _ in runs]

    def counted(inner, i):
        def call(*args, **kw):
            out = inner(*args, **kw)
            walkers[i].append(out[0].shape[0])
            return out
        return call
    trace.parent.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i, (fn, kernel) in enumerate(runs):
            inner = getattr(ops, kernel)
            setattr(ops, kernel, counted(inner, i))
            try:
                fn()
                torch.cuda.synchronize()
            finally:
                setattr(ops, kernel, inner)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text()).get("traceEvents", [])
    trace.unlink()
    ms = {kernel: [float(e.get("dur", 0)) / 1e3 for e in sorted(
        (e for e in events if e.get("cat") == "kernel"
         and f"{kernel}_kernel" in e.get("name", "")),
        key=lambda e: float(e["ts"]))] for _, kernel in runs}
    out = []
    for (_, kernel), w in zip(runs, walkers):
        out.append((w, ms[kernel][:len(w)]))
        ms[kernel] = ms[kernel][len(w):]
    return out


def sample_launches(runs, trace):
    """``launch_events`` of ``runs``, each run's launches all in the trace
    or the smoke fails: per run the walkers and the device ms of each of
    its launches, for an untimed replay of a batch.  One session for all
    runs: a later profiler session in a process has lost kernel events
    (PERF.md §7)."""
    res = []
    for (_, kernel), (walkers, ms) in zip(runs, launch_events(runs, trace)):
        need(0 < len(ms) == len(walkers), f"sample_launches: {len(ms)} "
             f"{kernel} kernel events for {len(walkers)} launches")
        res.append({"launches": len(ms), "walkers": walkers, "ms": ms,
                    "walkers_sum": sum(walkers), "kernel_ms_sum": sum(ms),
                    "walkers_max": max(walkers),
                    "walkers_median": statistics.median(walkers)})
    return res


def per_step_paths(engine, cfg, starts, report, profile_dir=None):
    """node2vec, per-step deepwalk and per-step simple batches through
    ``DynamicWalkEngine.walk`` on the final state, each with the launch
    counters zeroed just before and read just after; the whole-walk
    deepwalk batch's wall time beside them.  With ``profile_dir`` each
    batch runs once more under ``torch.profiler``.  Returns the kernels'
    lines."""
    import torch
    from repro_torch.core import walks
    from repro_torch.core.walks import WalkParams
    from repro_torch.kernels import ops
    from repro_torch.kernels.walk_sample import (walk_sample_ref,
                                                walk_sample_uniform_ref)
    from repro_torch.serve import DynamicWalkEngine
    st = engine.state
    V = cfg.num_vertices
    out, engines = {}, {}
    cases = (
        ("whole deepwalk", WalkParams("deepwalk", WALK_LEN), None),
        ("node2vec", WalkParams("node2vec", WALK_LEN, p=N2V_P, q=N2V_Q), None),
        ("per-step deepwalk", WalkParams("deepwalk", WALK_LEN), False),
        ("per-step simple", WalkParams("simple", WALK_LEN), False))
    for i, (name, params, whole) in enumerate(cases):
        eng = DynamicWalkEngine(st, cfg, params, whole_walk=whole, seed=10 + i)
        for k in walks.N2V_COUNTS:
            walks.N2V_COUNTS[k] = 0
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        p = eng.walk(starts)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        check_paths(name, p, st, starts, cfg)
        alive = int((p[:, 1:] >= 0).sum())
        out[name] = {"wall_ms": wall, "launches": counts,
                     "alive_steps": alive, "seed": eng.last_seed,
                     "n2v": dict(walks.N2V_COUNTS)}
        print(f"{name}: {wall:.2f} ms wall, {alive} alive steps, launches "
              f"{counts}" + (f", node2vec {walks.N2V_COUNTS}"
                             if name == "node2vec" else ""), flush=True)
        if name == "whole deepwalk":
            need(counts["walk_fused"] == 1, f"{name}: walk_fused launches")
        elif name == "node2vec":
            need(counts["walk_sample"] == walks.N2V_COUNTS["trials"] > 0,
                 f"{name}: walk_sample launches != proposal trials")
            need(counts["walk_fused"] == counts["walk_sample_uniform"] == 0,
                 f"{name}: launches of other kernels")
            a, b, c = (p[:, :-2].long(), p[:, 1:-1].long(), p[:, 2:].long())
            ok = (a >= 0) & (b >= 0) & (c >= 0)
            keys, cnt = torch.unique(a[ok] * V + b[ok], return_counts=True)
            key = int(keys[torch.argmax(cnt)])
            prev, cur = key // V, key % V
            sel = ok & (a == prev) & (b == cur)
            out[name]["dist"] = dict(
                check_distribution(f"{name} from (prev {prev}, cur {cur})",
                                   c[sel], n2v_probs(st, cfg, prev, cur,
                                                     N2V_P, N2V_Q), V),
                prev=prev, cur=cur)
        elif name == "per-step deepwalk":
            need(counts["walk_sample"] == WALK_LEN, f"{name}: walk_sample "
                 f"launches {counts['walk_sample']} != {WALK_LEN}")
            need(counts["walk_fused"] == 0, f"{name}: walk_fused launched")
            a, b = p[:, :-1].long(), p[:, 1:].long()
            hop = (a >= 0) & (b >= 0)
            v0 = int(torch.argmax(torch.bincount(a[hop], minlength=V)))
            out[name]["dist"] = dict(
                check_distribution(f"{name} out of vertex {v0}",
                                   b[hop & (a == v0)],
                                   first_order_probs(st, cfg, v0), V),
                vertex=v0)
        else:
            need(counts["walk_sample_uniform"] == WALK_LEN,
                 f"{name}: walk_sample_uniform launches "
                 f"{counts['walk_sample_uniform']} != {WALK_LEN}")
            need(counts["walk_fused"] == counts["walk_sample"] == 0,
                 f"{name}: launches of other kernels")
            # a frontier of the per-step simple walk, as scan_walk clamps it
            frontier = p[:, FRONTIER_STEP].clamp(min=0).to(
                torch.int32).contiguous()
        del p
        engines[name] = eng
    # B4a's and B4b's time on the paths, which the kernel queue ranks by:
    # the three per-step paths replayed in one profiler session, the
    # process's first; a trace that misses a launch fails the smoke
    replays = [(name, "walk_sample_uniform" if name == "per-step simple"
                else "walk_sample") for name in engines
               if name != "whole deepwalk"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        sls = sample_launches(
            [(partial(engines[name].walk, starts), kernel)
             for name, kernel in replays], Path(d) / "trace.json")
    for (name, kernel), sl in zip(replays, sls):
        print(f"{name} replay, {kernel}: {sl['launches']} "
              f"launches, {sl['walkers_sum']} walkers (median "
              f"{sl['walkers_median']}, max {sl['walkers_max']} a "
              f"launch), kernel {sl['kernel_ms_sum']:.3f} ms in all "
              f"(profiler)", flush=True)
        out[name][kernel] = sl
    # profiled last: a profiler run before sample_launches' has cost
    # that trace kernel events
    for name, eng in engines.items() if profile_dir is not None else ():
        try:        # a diagnostic: a profiler fault does not fail the smoke
            out[name]["profile"] = profiled(
                lambda: eng.walk(starts),
                profile_dir / f"{name.replace(' ', '_')}_trace.json", name,
                keep=False)
        except Exception as e:              # noqa: BLE001
            traceback.print_exc()
            out[name]["profile"] = {"error": repr(e)}
    report["per_step"] = out

    # one per-step sample of every walker, kernel vs plain, with the
    # uniforms fed: B4a at the starts; B4b at the starts and at the simple
    # walk's frontier, with the one uniform column its path passes
    g = torch.Generator(device="cuda").manual_seed(5)
    u = torch.rand((len(starts), 3), generator=g, device="cuda")
    u1 = u[:, :1].contiguous()
    tabs = (st.itable.prob, st.itable.alias, st.bias, st.nbr, st.deg)
    lines = []
    for name, where, rows, uu in (
            ("walk_sample", "starts", starts, u),
            ("walk_sample_uniform", "starts", starts, u1),
            ("walk_sample_uniform", "frontier", frontier, u1)):
        uniform = name == "walk_sample_uniform"
        if uniform:
            fn = partial(ops.walk_sample_uniform, st.nbr, st.deg, uu, rows=rows)
            ref = partial(walk_sample_uniform_ref, st.nbr, st.deg, uu, rows=rows)
        else:
            fn = partial(ops.walk_sample, *tabs, uu, rows=rows)
            ref = partial(walk_sample_ref, *tabs, uu, rows=rows)
        ms, got = cuda_ms(fn, reps=5)
        plain_ms, want = cuda_ms(ref, reps=1)
        err = max(path_diff(x, y, f"{name} on all walkers ({where})")
                  for x, y in zip(got, want))
        work = sample_work(rows, got[0], st.deg, uu.shape[1], uniform)
        b_ms, b_by = bound(work["bytes"], work["ops"])
        launches = sum(out[k]["launches"][name] for k in out)
        sectors = ""
        if uniform:
            work["sector_bytes"] = uniform_sectors(
                rows, got[1], st.nbr.shape[1], uu.shape[1])
            work["sector_ms"] = work["sector_bytes"] / hw.HBM_BW * 1e3
            sectors = (f"; at 32 B a sector {work['sector_bytes'] / 1e6:.3f} MB "
                       f"-> {work['sector_ms']:.5f} ms")
        print(f"{name}: {ms:.4f} ms for {len(rows)} walkers in place at the "
              f"{where}, u (B, {uu.shape[1]}); plain {plain_ms:.2f} ms, equal "
              f"on all walkers; needs {work['bytes'] / 1e6:.3f} MB and "
              f"{work['ops'] / 1e6:.3f} M ops -> bound {b_ms:.5f} ms "
              f"({b_by}){sectors}; launches on the per-step paths {launches}",
              flush=True)
        rec = dict(work, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, launches=launches)
        if where == "frontier":
            report[name]["frontier"] = rec
            continue
        report[name] = rec
        lines.append({"name": name, "route": "cuda",
                      "source": "src/repro_torch/csrc/walk_sample.cu",
                      "replaces": "src/repro/kernels/walk_sample.py:"
                                  + ("249" if uniform else "218"),
                      "launches": launches, "max_abs_err": err, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": None})
    return lines


def uniform_sectors(rows, slot, C, ucols):
    """The bytes one uniform pick of every walker moves at 32 bytes a
    sector: each distinct sector of the deg and nbr words it reads (a
    random word brings its whole sector), the sectors of ``u`` holding
    column 0 of a (B, ucols) layout, and the rows read and nxt and slot
    written as streams.  A diagnostic beside the word bound, which counts
    each word once."""
    import torch
    r = rows.long()
    B, live = r.numel(), slot >= 0
    deg_s = torch.unique(r // 8).numel()
    nbr_s = torch.unique((r[live] * C + slot[live].long()) // 8).numel()
    u_s = torch.unique(torch.arange(B, device=r.device) * ucols // 8).numel()
    return 32 * (deg_s + nbr_s + u_s + 3 * ((B + 7) // 8))


# ---------------------------------------------------------------- phase 3c
def digest(tensors, block_bytes=1 << 26):
    """SHA-256 over the SHA-256 of each block of rows (about
    ``block_bytes``) of the tensors, in order (None leaves skipped).  The
    blocks are copied to the host and hashed on a pool of threads, so a
    20 GiB state takes seconds; equal tensors of equal shapes give equal
    digests."""
    from concurrent.futures import ThreadPoolExecutor
    blocks = []
    for x in tensors:
        if x is None or x.shape[0] == 0:
            continue
        row = max(1, x[0].numel() * x.element_size())
        step = max(1, block_bytes // row)
        blocks += [x[i:i + step] for i in range(0, x.shape[0], step)]

    def one(b):
        return hashlib.sha256(b.contiguous().cpu().numpy()).digest()
    h = hashlib.sha256()
    with ThreadPoolExecutor(max_workers=8) as pool:
        for d in pool.map(one, blocks):
            h.update(d)
    return h.hexdigest()


def state_leaves(st):
    return list(st[:-1]) + list(st.itable)


def slice_digest(st, lo, hi):
    """Digest of rows [lo, hi) of every leaf of a state."""
    return digest([None if x is None else x[lo:hi] for x in state_leaves(st)])


def segment_work(path, frontier, deg, uniform):
    """The work one segment launch needs, counted as ``walk_work`` counts a
    whole walk, with each frontier exit counted as a hop that read its row
    and picked an nbr word (to the remote vertex), plus the t0, wid and
    frontier words."""
    import torch
    B, L1 = path.shape
    cur, nxt = path[:, :-1].long(), path[:, 1:].long().clone()
    ex = frontier[:, 0] >= 0
    rows = torch.nonzero(ex).squeeze(1)
    nxt[rows, frontier[ex, 1].long() - 1] = deg.shape[0] + frontier[ex, 0].long()
    drawn, moved = cur >= 0, nxt >= 0
    x_drawn = torch.unique(cur[drawn])
    x_moved = torch.unique(cur[moved])
    hops = torch.unique(cur[moved] * (1 << 32) + nxt[moved]).numel()
    words = 5 * B + B * L1 + x_drawn.numel() + hops
    ops = 0
    if not uniform:
        words += 2 * x_moved.numel() + int(deg[x_moved].long().sum())
        ops = 2 * int(deg[cur[moved]].long().sum())
    return {"bytes": 4 * words, "ops": ops, "alive_steps": int(drawn.sum()),
            "exits": int(ex.sum())}


class SegmentWork:
    """A backend that launches each relay segment through ``bk`` and then
    records the work the launch needed (``segment_work``, with host
    syncs), its live slots (start >= 0, 0 <= t0 <= L: the walkers it hands
    to tiles) beside its alive steps and exits, and the launch's time on
    the card (CUDA events behind a spin
    kernel of about 1 ms, so the wrapper's host work is not counted, as
    in ``cuda_ms``): for a replay of a relay batch outside its timed run,
    whose launches are the timed run's, one for one."""

    def __init__(self, bk, uniform):
        self.bk, self.uniform, self.works, self.events = bk, uniform, [], []

    def __getattr__(self, name):
        return getattr(self.bk, name)

    def sample_walk_segment(self, state, cfg, starts, t0, seed, params,
                            u=None, wid=None):
        import torch
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)
        a.record()
        path, frontier = self.bk.sample_walk_segment(
            state, cfg, starts, t0, seed, params, u=u, wid=wid)
        b.record()
        self.events.append((a, b))
        work = segment_work(path, frontier, state.deg, self.uniform)
        L = path.shape[1] - 1
        work["live"] = int(((starts >= 0) & (t0 >= 0) & (t0 <= L)).sum())
        self.works.append(work)
        return path, frontier


def relay_batches(cfg):
    """The sharded phase's walk batches: (name, params, overlap, stride):
    each walks every ``stride``-th start."""
    from repro_torch.core.walks import WalkParams
    return (("deepwalk", WalkParams("deepwalk", WALK_LEN), True, 1),
            ("deepwalk bulk", WalkParams("deepwalk", WALK_LEN), False, 1),
            ("ppr bulk", WalkParams("ppr", PPR_LEN, stop_prob=PPR_STOP),
             False, PPR_RELAY_STRIDE),
            ("simple", WalkParams("simple", WALK_LEN), True, 1))


def sharded_path(engine, cfg, starts, stream, report, mesh_h):
    """Phase 3c: write the inputs and the single-device results, run the
    4 gloo ranks and then one NCCL rank, check every rank's result.
    Fills ``mesh_h`` with what phase 3h holds its relays to (and the
    edges of its baselines).  Returns the segment kernel's line."""
    import torch
    from repro_torch.core.walks import random_walk
    st = engine.state
    V, W = cfg.num_vertices, len(starts)
    Vs = V // SHARDS
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_shards_"))
    try:
        np.savez(tmp / "inputs.npz", **stream._asdict(),
                 starts=starts.cpu().numpy())
        expect = {"V": V, "shards": SHARDS,
                  "round_stats": report["round_stats"],
                  "slices": [slice_digest(st, r * Vs, (r + 1) * Vs)
                             for r in range(SHARDS)],
                  "state": slice_digest(st, 0, V), "walks": {}}
        for name, params, _, stride in relay_batches(cfg):
            kind = name.split()[0]
            seed = RELAY_SEEDS[kind]
            if kind not in expect["walks"]:
                p = random_walk(st, cfg, starts[::stride].contiguous(),
                                seed, params)
                Wb = p.shape[0] // SHARDS
                expect["walks"][kind] = {
                    "seed": seed, "all": digest([p]),
                    "blocks": [digest([p[r * Wb:(r + 1) * Wb]])
                               for r in range(SHARDS)]}
                del p
        (tmp / "expect.json").write_text(json.dumps(expect))
        Vm = V // MESH_SHAPE[0]
        mesh_h.update(
            V=V, round_stats=report["round_stats"], edges=row_edges(st),
            slices=[slice_digest(st, r * Vm, (r + 1) * Vm)
                    for r in range(MESH_SHAPE[0])],
            walks={k: {"seed": x["seed"], "all": x["all"]}
                   for k, x in expect["walks"].items()})
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        gloo = spawn_ranks(tmp, "gloo", SHARDS)
        t_gloo = time.perf_counter() - t0
        nccl = spawn_ranks(tmp, "nccl", 1)
        t_nccl = time.perf_counter() - t0 - t_gloo
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    out = {"gloo_s": t_gloo, "nccl_s": t_nccl, "batches": {}}
    launches = 0
    for name, _, _, stride in relay_batches(cfg):
        per = [g["batches"][name] for g in gloo]
        need(len({(b["rounds"], b["overflow"], b["peak_slots"])
                  for b in per}) == 1, f"relay {name}: ranks disagree")
        seg = sorted(x for b in per for x in b["segment_ms"])
        rep = sorted(x for b in per for x in b["replay_ms"])
        lb = sorted(x for b in per for x in b["bound_ms"])
        exch = sorted(x for b in per for x in b["exchange_ms"])
        red = sorted(x for b in per for x in b["reduce_ms"])
        live = sorted(x for b in per for x in b["live"])
        steps = sorted(x for b in per for x in b["alive_steps"])
        b0 = per[0]
        launches += sum(b["launches"] for b in per)
        out["batches"][name] = dict(
            rounds=b0["rounds"], overflow=b0["overflow"],
            peak_slots=b0["peak_slots"], wall_s=max(b["wall_s"] for b in per),
            launches=sum(b["launches"] for b in per),
            segment_ms_median=seg[len(seg) // 2], segment_ms_max=seg[-1],
            segment_ms_sum=sum(seg), replay_ms_median=rep[len(rep) // 2],
            replay_ms_sum=sum(rep), bound_ms_median=lb[len(lb) // 2],
            bound_ms_sum=sum(lb),
            over_1ms=[x for x in seg if x >= 1.0],
            pairs=[list(zip(b["segment_ms"], b["bound_ms"])) for b in per],
            live_median=live[len(live) // 2], live_max=live[-1],
            live_sum=sum(live), alive_steps_median=steps[len(steps) // 2],
            alive_steps_sum=sum(steps),
            exchange_ms_median=exch[len(exch) // 2],
            exchange_ms_mean=statistics.mean(exch),
            reduce_ms_median=red[len(red) // 2],
            reduce_ms_mean=statistics.mean(red))
        o = out["batches"][name]
        o["walkers"] = W // stride
        print(f"relay {name} (S={SHARDS}, gloo, {W // stride} walkers): "
              f"{o['rounds']} rounds, "
              f"overflow {o['overflow']}, peak slots {o['peak_slots']}, wall "
              f"{o['wall_s']:.3f} s; walk_segment {o['launches']} launches, "
              f"median {o['segment_ms_median']:.4f} ms (max "
              f"{o['segment_ms_max']:.3f}, sum {o['segment_ms_sum']:.2f}; "
              f"{len(o['over_1ms'])} launches of 1 ms or more, sum "
              f"{sum(o['over_1ms']):.2f}); on the card alone (replay) median "
              f"{o['replay_ms_median']:.4f} ms (sum {o['replay_ms_sum']:.2f}); "
              f"bound per launch median "
              f"{o['bound_ms_median']:.5f} ms (sum {o['bound_ms_sum']:.3f}); "
              f"live slots per launch median {o['live_median']} (max "
              f"{o['live_max']}, sum {o['live_sum']}), alive steps median "
              f"{o['alive_steps_median']} (sum {o['alive_steps_sum']}); "
              f"exchange per round median "
              f"{o['exchange_ms_median']:.2f} ms, mean "
              f"{o['exchange_ms_mean']:.2f} ms; closing all-reduce median "
              f"{o['reduce_ms_median']:.2f} ms, mean {o['reduce_ms_mean']:.2f} "
              f"ms; home blocks equal to the single-device paths", flush=True)
    batches = out["batches"].values()
    gap = sum(o["segment_ms_sum"] - o["bound_ms_sum"] for o in batches)
    gap_med = sum(o["launches"] * (o["segment_ms_median"] - o["bound_ms_median"])
                  for o in batches)
    gap_rep = sum(o["launches"] * (o["replay_ms_median"] - o["bound_ms_median"])
                  for o in batches)
    out["segment_gap_ms"], out["segment_gap_median_ms"] = gap, gap_med
    out["segment_gap_replay_ms"] = gap_rep
    print(f"walk_segment over the {launches} gloo relay launches: sum of "
          f"(ms - bound) per launch {gap:.2f} ms; launches x (median ms - "
          f"median bound), by batch, {gap_med:.2f} ms; the same on the card "
          f"alone (replay medians) {gap_rep:.2f} ms", flush=True)
    n1 = nccl[0]["batches"]["deepwalk"]
    launches += n1["launches"]
    out["nccl_deepwalk"] = n1
    w1 = nccl[0]["whole"]
    print(f"relay deepwalk (S=1, nccl): {n1['rounds']} round(s), wall "
          f"{n1['wall_s']:.3f} s, paths equal to the single-device paths; "
          f"on all {W} walkers, in turns in that rank: walk_fused "
          f"{w1['walk_fused_ms']:.3f} ms, walk_segment "
          f"{w1['walk_segment_ms']:.3f} ms, paths equal", flush=True)
    t = gloo[0]["timing"]
    print(f"walk_segment on rank 0's round-1 slots ({t['slots']} slots, "
          f"{t['work']['alive_steps']} steps, {t['work']['exits']} exits): "
          f"{t['ms']:.4f} ms; plain {t['plain_ms']:.1f} ms, equal; needs "
          f"{t['work']['bytes'] / 1e6:.2f} MB and {t['work']['ops'] / 1e6:.2f} "
          f"M ops -> bound {t['bound_ms']:.5f} ms ({t['bound_by']}); ranks "
          f"gloo {t_gloo:.1f} s, nccl {t_nccl:.1f} s", flush=True)
    out["timing"] = t
    report["sharded"] = out
    return {"name": "walk_segment", "route": "cuda",
            "source": "src/repro_torch/csrc/walk_fused.cu",
            "replaces": "src/repro/kernels/walk_fused.py:444",
            "launches": launches, "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None}


def spawn_ranks(tmp, backend, n, target=None, timeout=SHARD_TIMEOUT_S,
                meanwhile=None):
    """Run ``target`` (default ``shard_rank``) on ``n`` ranks (``spawn``
    start method), ``meanwhile()`` here while they run, stop them all,
    fail unless every rank exited 0 with a result; returns the results by
    rank."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target or shard_rank,
                         args=(r, n, backend, str(tmp))) for r in range(n)]
    for p in procs:
        p.start()
    end = time.monotonic() + timeout
    try:        # until all exit, one fails, or the time is up
        if meanwhile is not None:
            meanwhile()
        while (time.monotonic() < end and any(p.is_alive() for p in procs)
               and not any(p.exitcode for p in procs)):
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    need(codes == [0] * n, f"{backend} ranks exited {codes}")
    return [json.loads((tmp / f"result_{backend}_{r}.json").read_text())
            for r in range(n)]


def shard_rank(rank, n, backend, tmp):
    """One rank of the sharded phase (runs in its own process)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import dyngraph as dg
    from repro_torch.core.backend import get_backend
    from repro_torch.core.walks import WalkParams
    from repro_torch.distributed.relay import make_relay
    from repro_torch.kernels import ops
    from repro_torch.serve import DynamicWalkEngine
    tmp = Path(tmp)
    torch.cuda.set_device(0)
    dist.init_process_group(
        backend, store=dist.FileStore(str(tmp / f"store_{backend}"), n),
        rank=rank, world_size=n, timeout=datetime.timedelta(seconds=120),
        device_id=torch.device("cuda", 0) if backend == "nccl" else None)
    group = dist.group.WORLD
    try:
        exp = json.loads((tmp / "expect.json").read_text())
        data = np.load(tmp / "inputs.npz")
        V = exp["V"]
        Vs = V // n
        cfg = dg.BingoConfig(num_vertices=V, capacity=256, bias_bits=16)
        for r in range(n):           # build in turn: one whole state at a time
            if r == rank:
                st = dg.from_edges(cfg, data["init_src"], data["init_dst"],
                                   data["init_w"], device="cuda")
                engine = DynamicWalkEngine(
                    st, cfg, WalkParams("deepwalk", WALK_LEN), group=group)
                del st
                torch.cuda.empty_cache()
            dist.barrier()
        for r, want in enumerate(exp["round_stats"]):
            lanes = [torch.from_numpy(np.ascontiguousarray(data[k][r])).cuda()
                     for k in ("is_insert", "u", "v", "w")]
            got = stats_list(engine.ingest(*lanes))
            need(got == want, f"rank {rank}: round {r + 1} stats {got} != "
                 f"single-device {want}")
        want = exp["slices"][rank] if n == exp["shards"] else exp["state"]
        need(slice_digest(engine.state, 0, Vs) == want,
             f"rank {rank}: state slice after the rounds != single device")
        starts = torch.from_numpy(data["starts"]).cuda()
        batches = relay_batches(cfg) if n == exp["shards"] else \
            relay_batches(cfg)[:1]
        res = {"batches": {}}
        bk = get_backend("fused")
        for name, params, overlap, stride in batches:
            kind = name.split()[0]
            sb = starts[::stride].contiguous()
            seed = exp["walks"][kind]["seed"]
            trace = []
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            if name == "deepwalk":       # through the engine
                engine.relay_trace = trace
                home = engine.walk(sb, seed)
                rounds, ovf, peak = (engine.last_relay[k] for k in
                                     ("rounds", "overflow", "peak_slots"))
            else:
                run = make_relay(bk, cfg, params, group, overlap=overlap,
                                 diagnostics=True)
                home, rounds, ovf, peak = run(engine.state, sb, seed,
                                              trace=trace)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            need(counts["walk_segment"] == rounds and
                 sum(counts.values()) == rounds,
                 f"rank {rank} {name}: launches {counts}, rounds {rounds}")
            want = exp["walks"][kind]["blocks"][rank] if n == exp["shards"] \
                else exp["walks"][kind]["all"]
            need(tuple(home.shape) == (len(sb) // n, params.length + 1) and
                 digest([home]) == want,
                 f"rank {rank} {name}: home block != single-device paths")
            res["batches"][name] = {
                "rounds": rounds, "overflow": ovf, "peak_slots": peak,
                "wall_s": wall, "launches": counts["walk_segment"],
                "segment_ms": [a.elapsed_time(b) for a, b in
                               (x["segment"] for x in trace)],
                "exchange_ms": [1e3 * x["exchange_s"] for x in trace],
                "reduce_ms": [1e3 * x["reduce_s"] for x in trace]}
            del home
        if n == exp["shards"]:      # each launch's bound, on a replay
            for name, params, overlap, stride in batches:
                kind = name.split()[0]
                rec = SegmentWork(bk, kind == "simple")
                home = make_relay(rec, cfg, params, group, overlap=overlap)(
                    engine.state, starts[::stride].contiguous(),
                    exp["walks"][kind]["seed"])[0]
                b = res["batches"][name]
                need(len(rec.works) == b["launches"] and digest([home]) ==
                     exp["walks"][kind]["blocks"][rank],
                     f"rank {rank} {name}: the replay differs")
                b["bound_ms"] = [bound(w["bytes"], w["ops"])[0]
                                 for w in rec.works]
                for key in ("live", "alive_steps", "exits"):
                    b[key] = [w[key] for w in rec.works]
                b["replay_ms"] = [x.elapsed_time(y) for x, y in rec.events]
                del home
        if rank == 0 and n > 1:
            res["timing"] = segment_timing(engine.state, starts, Vs, n)
        elif n == 1:
            res["whole"] = whole_vs_segment(engine.state, starts)
        dist.barrier()
        (tmp / f"result_{backend}_{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def whole_vs_segment(st, starts):
    """On one shard (the whole state, no remote neighbour): the whole-walk
    kernel and the segment kernel with every ``t0 = 0`` and ``wid = b`` on
    the deepwalk batch, timed in turns (whole, segment, segment, whole);
    their paths must be equal."""
    import torch
    from repro_torch.kernels import ops
    tabs = (st.itable.prob, st.itable.alias, st.bias, st.nbr, st.deg, None,
            starts)
    zeros = torch.zeros_like(starts)
    seed = RELAY_SEEDS["deepwalk"]
    times = {"walk_fused_ms": [], "walk_segment_ms": []}
    for name in ("walk_fused_ms", "walk_segment_ms", "walk_segment_ms",
                 "walk_fused_ms"):
        if name == "walk_fused_ms":
            ms, whole = cuda_ms(lambda: ops.walk_fused(*tabs, seed,
                                                       length=WALK_LEN))
        else:
            ms, (seg, fr) = cuda_ms(lambda: ops.walk_segment(
                *tabs, zeros, seed, length=WALK_LEN))
        times[name].append(ms)
    path_diff(seg, whole, "walk_segment on one shard vs walk_fused")
    need(bool((fr == -1).all()), "walk_segment on one shard: a frontier exit")
    return {k: statistics.median(v) for k, v in times.items()}


def segment_timing(st, starts, Vs, n):
    """The segment kernel and its plain version on rank 0's round-1 slots
    of the deepwalk batch (its residents in walker order, the other slots
    free): times, equality and the bound."""
    import torch
    from repro_torch.distributed.relay import relay_view, slot_count
    from repro_torch.kernels import ops
    from repro_torch.kernels.walk_fused import walk_segment_ref
    view = relay_view(st, 0, Vs)
    W = len(starts)
    Wl = slot_count(W, n)
    res = torch.nonzero((starts >= 0) & (starts < Vs)).squeeze(1)[:Wl]
    slot_start = torch.full((Wl,), -1, dtype=torch.int32, device="cuda")
    slot_wid = slot_start.clone()
    slot_start[:len(res)] = starts[res]
    slot_wid[:len(res)] = res.to(torch.int32)
    t0 = torch.zeros(Wl, dtype=torch.int32, device="cuda")
    args = (view.itable.prob, view.itable.alias, view.bias, view.nbr,
            view.deg, None, slot_start, t0)
    kw = dict(length=WALK_LEN, seed=RELAY_SEEDS["deepwalk"], wid=slot_wid)
    ms, got = cuda_ms(lambda: ops.walk_segment(*args, **kw))
    plain_ms, want = cuda_ms(lambda: walk_segment_ref(*args, **kw), reps=1)
    err = max(path_diff(a, b, "walk_segment round 1") for a, b in
              zip(got, want))
    work = segment_work(got[0], got[1], view.deg, False)
    b_ms, b_by = bound(work["bytes"], work["ops"])
    return {"slots": Wl, "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            "bound_ms": b_ms, "bound_by": b_by, "work": work}


def host_counts(fn):
    """Host-side work of one call of ``fn()`` under ``torch.profiler``:
    aten operator calls, kernel launches and stream synchronizations."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {"aten_calls": 0, "launches": 0, "syncs": 0}
    for e in prof.key_averages():
        if e.key.startswith("aten::"):
            counts["aten_calls"] += e.count
        elif e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"):
            counts["launches"] += e.count
        elif e.key == "cudaStreamSynchronize":
            counts["syncs"] += e.count
    return counts


def host_insert(row, v, w, C):
    if len(row) >= C:
        return False
    row.append((v, w))
    return True


def host_delete(row, v):
    """The earliest slot holding ``v`` goes; the tail slot fills it."""
    for i, (x, _) in enumerate(row):
        if x == v:
            row[i] = row[-1]
            row.pop()
            return True
    return False


def streaming(engine, cfg, report, rng):
    """``STREAM_UPDATES`` mixed single-edge updates through
    ``stream_updates``, one call per update with a sync after each (its
    latency on the host clock): deletes of edges present at the time,
    inserts of new edges with degree biases.  The touched vertices' rows
    are held against a host simulation of the same sequence, and their
    counters, group types and alias rows against a rebuild from the rows."""
    import torch
    from repro_torch.core.dyngraph import build_itable_rows, build_vertex_groups
    from repro_torch.core.updates import stream_updates
    from repro_torch.kernels import ops
    st = engine.state
    V, C = cfg.num_vertices, cfg.capacity
    deg = st.deg.cpu().numpy()
    indeg = torch.bincount(st.nbr[st.nbr >= 0].long(), minlength=V).cpu().numpy()
    live = np.flatnonzero(deg > 0)
    del_verts = rng.choice(live, 400, replace=False)
    ins_verts = rng.integers(0, V, 400)
    touched = np.unique(np.concatenate([del_verts, ins_verts]))
    tt = torch.from_numpy(touched).cuda()
    nbr_h, bias_h = st.nbr[tt].cpu().numpy(), st.bias[tt].cpu().numpy()
    sim = {int(u): list(zip(nbr_h[i, :deg[u]].tolist(),
                            bias_h[i, :deg[u]].tolist()))
           for i, u in enumerate(touched)}
    seq, want_ok = [], []
    for _ in range(STREAM_UPDATES):
        if rng.random() < 0.5:
            u = int(rng.choice(del_verts))
            if sim[u]:
                v = sim[u][rng.integers(len(sim[u]))][0]
                seq.append((False, u, v, 0))
                want_ok.append(host_delete(sim[u], v))
                continue
        u, v = int(rng.choice(ins_verts)), int(rng.integers(V))
        w = int(np.clip(indeg[v], 1, (1 << cfg.bias_bits) - 1))
        seq.append((True, u, v, w))
        want_ok.append(host_insert(sim[u], v, w, C))
    ins, uu, vv, ww = (np.array(x) for x in zip(*seq))
    lat, oks = [], []
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for i in range(len(seq)):
        t0 = time.perf_counter()
        _, ok = stream_updates(st, cfg, ins[i:i + 1], uu[i:i + 1],
                               vv[i:i + 1], ww[i:i + 1])
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        oks.append(ok)
    total = time.perf_counter() - t_all
    need(all(v == 0 for v in ops.launch_counts().values()),
         "streaming updates launched a kernel")
    got_ok = torch.cat(oks).cpu().numpy().tolist()
    need(got_ok == want_ok, "stream_updates ok flags != host simulation")
    deg2 = st.deg[tt].cpu().numpy()
    nbr2, bias2 = st.nbr[tt].cpu().numpy(), st.bias[tt].cpu().numpy()
    for i, u in enumerate(touched):
        row = sorted(zip(nbr2[i, :deg2[i]].tolist(), bias2[i, :deg2[i]].tolist()))
        need(row == sorted(sim[int(u)]), f"vertex {u}: row != host simulation")
        need((nbr2[i, deg2[i]:] == -1).all(), f"vertex {u}: padding")
    ttl = tt.long()
    _, _, gsize, digitsum, gtype, wdec = build_vertex_groups(
        cfg, st.bias[ttl], st.frac[ttl], st.deg[ttl])
    itab = build_itable_rows(cfg, digitsum, wdec)
    for name, a, b in (("gsize", gsize, st.gsize[ttl]),
                       ("digitsum", digitsum, st.digitsum[ttl]),
                       ("gtype", gtype, st.gtype[ttl]),
                       ("itable.prob", itab.prob, st.itable.prob[ttl]),
                       ("itable.alias", itab.alias, st.itable.alias[ttl])):
        need(torch.equal(a, b), f"streaming: {name} != rebuild from the rows")
    try:    # a diagnostic: a profiler fault does not fail the smoke
        u0 = int(touched[0])
        v0 = int(st.nbr[u0, 0]) if int(st.deg[u0]) else 0
        ops_ins = host_counts(lambda: stream_updates(st, cfg, [True], [u0],
                                                     [v0], [1]))
        ops_del = host_counts(lambda: stream_updates(st, cfg, [False], [u0],
                                                     [v0], [0]))
        print(f"streaming host work per update: insert {ops_ins}, delete "
              f"{ops_del}", flush=True)
    except Exception as e:                  # noqa: BLE001
        traceback.print_exc()
        ops_ins = ops_del = {"error": repr(e)}
    lat_s = sorted(lat)
    res = {"updates": len(seq), "insert_host_work": ops_ins,
           "delete_host_work": ops_del, "inserts": int(ins.sum()),
           "applied": int(sum(got_ok)), "touched_vertices": len(touched),
           "median_ms": statistics.median(lat),
           "p99_ms": lat_s[min(len(lat_s) - 1, int(0.99 * len(lat_s)))],
           "mean_ms": statistics.mean(lat), "total_s": total}
    report["streaming"] = res
    print(f"streaming: {res['updates']} updates ({res['inserts']} inserts, "
          f"{res['applied']} applied) on {len(touched)} vertices in "
          f"{total:.2f} s; per update median {res['median_ms']:.3f} ms, p99 "
          f"{res['p99_ms']:.3f} ms; rows equal to the host simulation, "
          f"counters and alias rows equal to a rebuild", flush=True)


# --------------------------------------------------------------- phase 3f
SERVE_SEED = 20
SERVE_LADDER = (256, 512)
SERVE_WALK_BUCKETS = (16384, 65536, 262144)
SERVE_RETRY_BATCH = 65536
SERVE_WALKS, SERVE_MAX_REQ = 12, 65536
GROWTH_WINDOWS = 4
NO_SYNC_WINDOW = 1                 # this window runs under sync debug "error"
CHECK_VERTICES = 4096
RECOVERY_SCALE = 17
# phase 3g: the sharded serving layer (4 gloo ranks on the one card)
CHAOS_SEED, CHAOS_WALKERS = 2, 65536
CHAOS_KILL_ROUNDS = 8               # the killed relay's round bound
SERVE_SHARD_TIMEOUT_S = 300         # phase 3g's ranks, all together
# phase 3h: the 2D vertex x walker mesh (4 gloo ranks on the one card)
MESH_SHAPE, MESH_DIMS = (2, 2), ("data", "walker")
WALKER_AXES = ("walker",)
MESH_TIMEOUT_S = 360                # phase 3h's ranks, all together
MESH_BATCHES = (("deepwalk", True), ("deepwalk", False), ("simple", False))
BASELINE_UPDATES, BASELINE_SEED = 10, 30


def growth_edges(src, dst, w, V, C, n, rng):
    """Up to ``n`` edges, in a seeded order, that a capacity-``C`` build of
    the whole graph drops (rank >= C in row order) from rows whose degree
    in the whole graph is at most 2C: growth traffic on hub rows that fits
    the next rung (scale 20 has 402,402 such edges; a smaller graph fewer,
    and its growth windows are cut to what there is)."""
    order = np.argsort(src, kind="stable")
    s = src[order]
    first = np.r_[True, s[1:] != s[:-1]]
    idx = np.arange(len(s))
    rank = idx - np.maximum.accumulate(np.where(first, idx, -1))
    deg = np.bincount(src, minlength=V)
    pick = order[(rank >= C) & (deg[s] <= 2 * C)]
    need(len(pick) >= GROWTH_WINDOWS, f"growth traffic: {len(pick)} dropped "
         f"edges on rows of degree <= {2 * C}")
    pick = rng.permutation(pick)[:n]
    return src[pick], dst[pick], w[pick]


def serving_events(rng, n_updates, n_walks, V, max_req):
    """Open-loop bursts of 1-3 requests a tick (as ``benchmarks/
    bench_serving.py:_events``): the updates in order, ``n_walks`` walk
    requests of 1..``max_req`` random starts, in a seeded order."""
    kinds = rng.permutation(np.array([0] * n_updates + [1] * n_walks))
    bursts, i, nxt = [], 0, 0
    while i < len(kinds):
        burst = []
        for kind in kinds[i:i + int(rng.integers(1, 4))]:
            if kind == 0:
                burst.append(("update", nxt))
                nxt += 1
            else:
                n = int(rng.integers(1, max_req + 1))
                burst.append(("walk", rng.integers(0, V, n).astype(np.int32)))
            i += 1
        bursts.append(burst)
    return bursts


def row_edges(st):
    """The state's edges in row order as host arrays ``(src, dst, bias)``
    (integer mode)."""
    import torch
    live = (torch.arange(st.nbr.shape[1], device=st.nbr.device)[None, :]
            < st.deg[:, None])
    src = torch.repeat_interleave(
        torch.arange(st.nbr.shape[0], dtype=torch.int32,
                     device=st.nbr.device), st.deg.long())
    return (src.cpu().numpy(), st.nbr[live].cpu().numpy(),
            st.bias[live].cpu().numpy())


class ServingProbe:
    """The instruments of phase 3f's live run, wrapped around one engine:
    per window the ingest's host time and the classifier's device time
    (CUDA events) with the bytes its lanes need, the drains' host time,
    the migration's time and its pins (the state right after it, by
    digest, and the edges in row order for ``from_edges`` at C'), the
    audits at both tiers, and each ``R_CAPACITY`` quarantine checked
    against its row.  Time spent in the pins is kept in ``paused`` and
    left out of the scheduler's clock and the phase's rates."""

    def __init__(self, engine):
        self.engine = engine
        self.paused = 0.0
        self.windows, self.classify_log, self.drains = [], [], []
        self.migration = None
        self.audits = []
        self.capacity_quarantines = 0
        self._in_window = None
        engine.ingest = self.wrap_ingest(engine.ingest)
        engine.drain_guard = self.wrap_drain(engine.drain_guard)
        engine._migrate = self.wrap_migrate(engine._migrate)
        self.wrap_guard()

    def clock(self):
        return time.monotonic() - self.paused

    def pause(self, t0):
        self.paused += time.perf_counter() - t0

    def wrap_guard(self):
        g = self.engine.guard
        inner, settle, regrow = g.classify, g.settle_retry, g.regrow
        V = self.engine.cfg.num_vertices

        def classify(state, ins, u, v, w):
            import torch
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            r = inner(state, ins, u, v, w)
            b.record()
            dele = ~ins & (u >= 0) & (u < V) & (v >= 0) & (v < V)
            slots = torch.where(dele, state.deg[u.clamp(0, V - 1).long()],
                                0).sum()
            self.classify_log.append((self._in_window, a, b, u.shape[0],
                                      slots))
            return r

        def settle_retry(rnd, entries, reasons):
            import torch
            from repro_torch.core.updates import R_CAPACITY
            q0 = len(g.quarantine)
            n = settle(rnd, entries, reasons)
            t0 = time.perf_counter()
            new = [q.u for q in g.quarantine[q0:] if q.reason == R_CAPACITY]
            if new:
                eng = self.engine
                need(eng.tier > 0, "an R_CAPACITY quarantine before the "
                     "regrow")
                deg = eng.state.deg[torch.tensor(new, device="cuda")]
                need(bool((deg == eng.cfg.capacity).all()),
                     "an R_CAPACITY quarantine names a row below capacity")
                self.capacity_quarantines += len(new)
            self.pause(t0)
            return n

        def regrow_(cfg_next):
            regrow(cfg_next)
            self.wrap_guard()

        g.classify, g.settle_retry, g.regrow = classify, settle_retry, regrow_

    def wrap_ingest(self, inner):
        def ingest(*a, **k):
            import torch
            i = len(self.windows)
            self._in_window = i
            t0 = time.perf_counter()
            if i == NO_SYNC_WINDOW:
                torch.cuda.set_sync_debug_mode("error")
            try:
                out = inner(*a, **k)
            finally:
                if i == NO_SYNC_WINDOW:
                    torch.cuda.set_sync_debug_mode(0)
                self._in_window = None
            self.windows.append({"ingest_ms": (time.perf_counter() - t0) * 1e3,
                                 "lanes": int(k.get("n_valid") or len(a[1]))})
            return out
        return ingest

    def wrap_drain(self, inner):
        def drain_guard():
            t0 = time.perf_counter()
            n = inner()
            if n:
                self.drains.append({"rounds": n, "tier": self.engine.tier,
                                    "ms": (time.perf_counter() - t0) * 1e3})
            return n
        return drain_guard

    def audit(self):
        """``audit(pressure=True)``: every corruption rule zero, and
        ``at_capacity`` the rows at deg == C exactly when inserts wait."""
        import torch
        from repro_torch.core.invariants import DEVICE_RULES
        eng = self.engine
        t0 = time.perf_counter()
        a = eng.audit(pressure=True)
        ms = (time.perf_counter() - t0) * 1e3
        full = int((eng.state.deg == eng.cfg.capacity).sum()) \
            if a["pending_depth"] else 0
        bad = {r: a[r] for r in DEVICE_RULES if r != "at_capacity" and a[r]}
        need(not bad, f"audit at tier {eng.tier}: {bad}")
        need(a["at_capacity"] == full, f"audit at tier {eng.tier}: "
             f"at_capacity {a['at_capacity']} != {full} full rows")
        self.audits.append(dict(a, ms=ms))
        return a

    def wrap_migrate(self, inner):
        def migrate():
            import torch
            from repro_torch.core.updates import R_CAPACITY
            eng = self.engine
            t0 = time.perf_counter()
            need(not any(q.reason == R_CAPACITY for q in eng.guard.quarantine),
                 "an R_CAPACITY quarantine before the regrow")
            self.audit()
            old = sum(x.numel() * x.element_size() for x in
                      state_leaves(eng.state) if x is not None)
            torch.cuda.synchronize()
            self.pause(t0)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t1 = time.perf_counter()
            a.record()
            inner()
            b.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
            t0 = time.perf_counter()
            new = sum(x.numel() * x.element_size() for x in
                      state_leaves(eng.state) if x is not None)
            self.migration = {
                "ms": a.elapsed_time(b), "wall_ms": wall,
                "old_bytes": old, "new_bytes": new,
                "bound_ms": (old + new) / hw.HBM_BW * 1e3,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "digest": digest(state_leaves(eng.state)),
                "edges": row_edges(eng.state),
                "pin_s": None}
            self.migration["pin_s"] = time.perf_counter() - t0
            self.pause(t0)
        return migrate

    def window_report(self, trace):
        """Per window: its kind, lanes, host ingest ms, classifier device
        ms beside its bytes bound; and the retry rounds' classifier ms."""
        from repro_torch.serve.scheduler import UpdateOp
        cls = {}
        retry = []
        for w, a, b, B, slots in self.classify_log:
            nbytes = B * (1 + 4 + 4 + 4 + 4 + 4) + 4 * int(slots)
            row = {"ms": a.elapsed_time(b), "bytes": nbytes,
                   "bound_ms": nbytes / hw.HBM_BW * 1e3}
            (retry.append(row) if w is None else cls.__setitem__(w, row))
        ops_ = [op for op in trace if isinstance(op, UpdateOp)]
        for i, (win, op) in enumerate(zip(self.windows, ops_)):
            win.update(kind="growth" if i >= len(ops_) - GROWTH_WINDOWS
                       else "mixed", classify=cls[i])
        return retry


def serving_phase(args, report, graph, stream, handoff):
    """Phase 3f: the serving layer at full width (module docstring).
    Fills ``handoff`` with what phase 3g holds the sharded engine to."""
    import torch
    from repro_torch.core import dyngraph as dg
    from repro_torch.core.invariants import check_state
    from repro_torch.core.walks import WalkParams, random_walk
    from repro_torch.kernels import ops
    from repro_torch.kernels.update_fused import plan_round
    from repro_torch.serve import DynamicWalkEngine, GuardPolicy
    from repro_torch.serve.scheduler import (DrainOp, RegrowOp,
                                             SchedulerConfig,
                                             ServingScheduler, UpdateOp,
                                             WalkOp, replay_admission_trace)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    src, dst, w = graph
    V = 1 << args.scale
    rounds, batch = stream.is_insert.shape
    cfg = dg.BingoConfig(num_vertices=V, capacity=SERVE_LADDER[0],
                         bias_bits=16, capacity_ladder=SERVE_LADDER)
    rng = np.random.default_rng(SERVE_SEED)
    gsrc, gdst, gw = growth_edges(src, dst, w, V, cfg.capacity,
                                  GROWTH_WINDOWS * batch, rng)
    updates = [tuple(a[r] for a in (stream.is_insert, stream.u, stream.v,
                                    stream.w)) for r in range(rounds)]
    gwin = len(gsrc) // GROWTH_WINDOWS
    for k in range(GROWTH_WINDOWS):
        sl = slice(k * gwin, (k + 1) * gwin)
        updates.append((np.ones(gwin, bool), gsrc[sl], gdst[sl], gw[sl]))
    bursts = serving_events(rng, len(updates), SERVE_WALKS, V,
                            min(SERVE_MAX_REQ, V))
    params = WalkParams("deepwalk", WALK_LEN)
    sched_cfg = SchedulerConfig(
        update_lanes=batch, max_update_delay=4, max_walk_queue=1 << 40,
        max_update_queue=1 << 40, guard_drain_rounds=8,
        regrow_watermark=0.95)

    def make_engine():
        st = dg.from_edges(cfg, stream.init_src, stream.init_dst,
                           stream.init_w, device="cuda")
        return DynamicWalkEngine(
            st, cfg, params, seed=SERVE_SEED,
            guard=GuardPolicy(retry_batch=SERVE_RETRY_BATCH),
            walk_buckets=SERVE_WALK_BUCKETS)

    # ---- the live run
    engine = make_engine()
    probe = ServingProbe(engine)
    probe.audit()                                   # tier 0, before traffic
    sched = ServingScheduler(engine, sched_cfg, clock=probe.clock)
    capped = []             # ticks whose dispatch stopped at max_inflight
    dispatch = sched._dispatch_walks

    def dispatch_():
        dispatch()
        if sched._walk_queue and len(sched._inflight) >= sched_cfg.max_inflight:
            capped.append(sched.tick_count)
    sched._dispatch_walks = dispatch_
    results = {}
    ops.reset_launch_counts()
    plan_round.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for burst in bursts:
        for kind, x in burst:
            if kind == "update":
                need(sched.submit_update(*updates[x]), "update refused")
            else:
                need(sched.submit_walk(x) is not None, "walk refused")
        sched.tick()
        results.update((r.rid, r) for r in sched.poll())
    results.update((r.rid, r) for r in sched.close())
    torch.cuda.synchronize()
    live_s = time.perf_counter() - t0 - probe.paused
    counts = ops.launch_counts()
    trace = sched.trace
    n_walk_ops = sum(isinstance(op, WalkOp) for op in trace)
    n_upd_ops = sum(isinstance(op, UpdateOp) for op in trace)
    regrows = [i for i, op in enumerate(trace) if isinstance(op, RegrowOp)]
    print(f"serving: {len(bursts)} ticks, {n_upd_ops} update windows "
          f"({engine.retry_rounds} retry rounds), {n_walk_ops} walk cohorts "
          f"for {len(results)} requests, "
          f"{sum(isinstance(op, DrainOp) for op in trace)} drains, regrow at "
          f"trace ops {regrows}; launches {counts}", flush=True)
    # (f) the kernels ran on the card, once a cohort / window / retry round
    need(counts["walk_fused"] == n_walk_ops,
         f"serving: walk_fused launches {counts['walk_fused']} != "
         f"{n_walk_ops} cohorts")
    need(counts["update_fused"] == n_upd_ops + engine.retry_rounds
         == plan_round.launches,
         f"serving: update_fused launches {counts['update_fused']} != "
         f"{n_upd_ops} windows + {engine.retry_rounds} retry rounds")
    need(len(regrows) == 1 and engine.tier == 1 and probe.migration,
         f"serving: expected one regrow to {SERVE_LADDER[1]}, got {regrows}")
    need(len(results) == SERVE_WALKS, "serving: a walk request was lost")
    # (c) conservation
    engine.guard.check_conservation()
    sched.check_conservation()
    # (d) invariants at the new tier, and the full check on seeded rows
    probe.audit()
    deg = engine.state.deg.cpu().numpy()
    crng = np.random.default_rng(SERVE_SEED + 1)
    wide = np.flatnonzero(deg > SERVE_LADDER[0])
    verts = np.unique(np.concatenate([
        crng.choice(V, CHECK_VERTICES // 2, replace=False),
        crng.choice(wide, min(len(wide), CHECK_VERTICES // 2),
                    replace=False)]))
    t1 = time.perf_counter()
    check_state(engine.state, engine.cfg, vertices=verts)
    check_s = time.perf_counter() - t1
    retry = probe.window_report(trace)
    lat = sorted(r.latency_s for r in results.values())
    steps = sum(int((r.paths[:, 1:] >= 0).sum()) for r in results.values())
    lanes = sum(op.n_valid for op in trace if isinstance(op, UpdateOp))
    guard_books = engine.guard.snapshot()
    t1 = time.perf_counter()
    live_digest = digest(state_leaves(engine.state))
    digest_s = time.perf_counter() - t1
    live_paths = {rid: r.paths for rid, r in results.items()}
    pin = probe.migration
    out = {
        "ticks": len(bursts), "windows": probe.windows, "drains": probe.drains,
        "retry_rounds": engine.retry_rounds, "retry_classify": retry,
        "walk_cohorts": n_walk_ops, "launches": counts,
        "migration": {k: v for k, v in pin.items()
                      if k not in ("digest", "edges")},
        "audits": probe.audits, "check_state_vertices": len(verts),
        "check_state_s": check_s, "digest_s": digest_s,
        "latency_p50_ms": lat[len(lat) // 2] * 1e3,
        "latency_p99_ms": lat[min(len(lat) - 1,
                                  int(math.ceil(0.99 * len(lat))) - 1)] * 1e3,
        "walk_steps": steps, "walk_steps_per_s": steps / live_s,
        "updates": lanes, "updates_per_s": lanes / live_s,
        "live_s": live_s, "paused_s": probe.paused,
        "guard": {k: guard_books[k] for k in
                  ("ingested", "accepted", "quarantined", "retried",
                   "reason_counts")},
        "pending": len(guard_books["pending"]),
        "capacity_quarantines": probe.capacity_quarantines}
    del sched, probe, results, engine, dispatch, dispatch_
    gc.collect()                  # the probe's wrappers and the engine
    torch.cuda.empty_cache()      # reference each other
    need(torch.cuda.memory_allocated() < base + 2**30,
         "serving: the live engine's tables were not freed")
    for i, win in enumerate(out["windows"]):
        c = win["classify"]
        print(f"  window {i} ({win['kind']}, {win['lanes']} lanes): ingest "
              f"{win['ingest_ms']:.3f} ms host; classifier {c['ms']:.4f} ms "
              f"(bound {c['bound_ms']:.4f} ms, {c['bytes'] / 1e6:.2f} MB)"
              + (" [under set_sync_debug_mode('error')]"
                 if i == NO_SYNC_WINDOW else ""), flush=True)
    for d in out["drains"]:
        print(f"  drain of {d['rounds']} rounds at tier {d['tier']}: "
              f"{d['ms']:.1f} ms host", flush=True)
    m = out["migration"]
    print(f"  regrow 256 -> 512: migration {m['ms']:.2f} ms (CUDA events; "
          f"{m['wall_ms']:.2f} ms host), bound {m['bound_ms']:.3f} ms "
          f"({(m['old_bytes'] + m['new_bytes']) / 2**30:.2f} GiB: old tables "
          f"read once, new written once), peak {m['peak_gib']:.1f} GiB; "
          f"{out['retry_rounds']} retry rounds, classifier "
          f"{sum(r['ms'] for r in retry):.3f} ms in them", flush=True)
    print(f"  audits (pressure=True): "
          + "; ".join(f"tier {a['tier']} {a['ms']:.1f} ms, at_capacity "
                      f"{a['at_capacity']}, pending {a['pending_depth']}"
                      for a in out["audits"])
          + f"; check_state on {len(verts)} rows {check_s:.1f} s", flush=True)
    print(f"  cohort latency p50 {out['latency_p50_ms']:.1f} ms, p99 "
          f"{out['latency_p99_ms']:.1f} ms; {steps} walk steps "
          f"({out['walk_steps_per_s'] / 1e6:.1f} M steps/s), {lanes} updates "
          f"({out['updates_per_s'] / 1e6:.3f} M updates/s) over "
          f"{live_s:.2f} s (pins {out['paused_s']:.1f} s left out); guard "
          f"{out['guard']}, pending {out['pending']}, R_CAPACITY quarantines "
          f"{out['capacity_quarantines']} (each at a full row after the "
          f"regrow)", flush=True)

    # (b) the regrow pin: the migrated state is from_edges at C' over its
    # edges in row order (digests: no third full state is held)
    t1 = time.perf_counter()
    built = dg.from_edges(cfg.tier_config(1), *pin["edges"], device="cuda")
    need(digest(state_leaves(built)) == pin["digest"],
         "serving: the migrated state != from_edges at C' = 512")
    del built, pin
    torch.cuda.empty_cache()
    out["regrow_pin_s"] = time.perf_counter() - t1

    # (a) live == replay: a fresh engine replays the admission trace
    t1 = time.perf_counter()
    fresh = make_engine()
    replayed = iter(replay_admission_trace(fresh, trace))
    for op in trace:
        if isinstance(op, WalkOp):
            rep = next(replayed)
            off = np.cumsum([0] + list(op.sizes))
            for j, rid in enumerate(op.rids):
                need(np.array_equal(live_paths[rid], rep[off[j]:off[j + 1]]),
                     f"serving: request {rid} != its replay")
    need(fresh.tier == 1 and fresh.guard.snapshot() == guard_books,
         "serving: the replay's tier or guard books differ")
    need(digest(state_leaves(fresh.state)) == live_digest,
         "serving: the replay's final state != the live one")
    out["replay_s"] = time.perf_counter() - t1
    # what phase 3g's sharded engine must give: this run's traffic, trace,
    # requests, books, regrows and final slices, and a whole walk of the
    # final state for its chaos relay
    t1 = time.perf_counter()
    chaos_starts = torch.from_numpy(np.random.default_rng(CHAOS_SEED).integers(
        0, V, CHAOS_WALKERS).astype(np.int32)).cuda()
    chaos = random_walk(fresh.state, fresh.cfg, chaos_starts, CHAOS_SEED,
                        params)
    handoff.update(
        init=(stream.init_src, stream.init_dst, stream.init_w),
        updates=updates, bursts=bursts, sched_cfg=dataclasses.asdict(sched_cfg),
        trace=[op_digest(op) for op in trace],
        timing_free=not capped, capped_ticks=capped,
        paths={rid: array_digest(p) for rid, p in live_paths.items()},
        guard=books_digest(guard_books), regrow_counts=fresh.regrow_counts,
        retry_rounds=out["retry_rounds"], tier=fresh.tier,
        slices={S: [slice_digest(fresh.state, r * (V // S),
                                 (r + 1) * (V // S)) for r in range(S)]
                for S in (SHARDS, MESH_SHAPE[0])},
        chaos={"starts": chaos_starts.cpu().numpy(), "seed": CHAOS_SEED,
               "all": digest([chaos])},
        trace_ops=trace,
        windows=[op for op in trace if isinstance(op, UpdateOp)][:2],
        migration_ms=out["migration"]["ms"],
        latency=(out["latency_p50_ms"], out["latency_p99_ms"]))
    del chaos
    out["handoff_s"] = time.perf_counter() - t1
    del fresh, replayed, live_paths
    torch.cuda.empty_cache()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"serving: live == replay on all {n_walk_ops} cohorts and the final "
          f"state (digest {live_digest[:16]}); regrow pin equal "
          f"({out['regrow_pin_s']:.1f} s); replay {out['replay_s']:.1f} s; "
          f"peak {out['peak_gib']:.1f} GiB; phase {out['phase_s']:.1f} s",
          flush=True)
    report["serving"] = out


def recovery_phase(args, report):
    """Phase 3f, recovery: crash and restore at 2^``RECOVERY_SCALE``
    vertices with the serving widths (C 256 -> 512, 16-bit biases)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.core import dyngraph as dg
    from repro_torch.core.walks import WalkParams
    from repro_torch.graph.rmat import degree_bias, rmat_edges
    from repro_torch.graph.streams import make_update_stream
    from repro_torch.serve import (DynamicWalkEngine, GuardPolicy,
                                   RecoverableEngine)
    from repro_torch.train import checkpoint as ckpt
    t_phase = time.perf_counter()
    scale = min(args.scale, RECOVERY_SCALE)
    V, rounds = 1 << scale, 10
    src, dst = rmat_edges(scale, 8, seed=1)
    w = degree_bias(src, dst, V, bias_bits=16)
    batch = min(100_000 >> (20 - scale), len(src) // (4 * rounds))
    stream = make_update_stream(src, dst, w, batch_size=batch, rounds=rounds,
                                mode="mixed", seed=1)
    cfg = dg.BingoConfig(num_vertices=V, capacity=SERVE_LADDER[0],
                         bias_bits=16, capacity_ladder=SERVE_LADDER)
    params = WalkParams("deepwalk", WALK_LEN)
    guard = GuardPolicy(retry_batch=SERVE_RETRY_BATCH)
    starts = torch.arange(0, V, 8, dtype=torch.int32, device="cuda")

    def engine():
        st = dg.from_edges(cfg, stream.init_src, stream.init_dst,
                           stream.init_w, device="cuda")
        return DynamicWalkEngine(st, cfg, params, seed=SERVE_SEED,
                                 guard=guard)

    def drive(e):
        for r in range(rounds):
            e.ingest(stream.is_insert[r], stream.u[r], stream.v[r],
                     stream.w[r])
            e.walk(starts)

    twin = engine()                           # the uninterrupted run
    drive(twin)
    need(len(twin.guard.pending) > 0, "recovery: no capacity spill to regrow")
    twin.regrow()
    want = digest(state_leaves(twin.state))
    want_paths = twin.walk(starts).cpu()
    del twin
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="smoke_recovery_")
    writes, copies = [], []
    save = ckpt.save_checkpoint

    def timed_write(*a, **k):
        t = time.perf_counter()
        out = save(*a, **k)
        writes.append(time.perf_counter() - t)
        return out
    ckpt.save_checkpoint = timed_write
    try:
        rec = RecoverableEngine(engine(), ckpt_dir=tmp, checkpoint_every=3,
                                keep=2)
        take = rec.ckpt.save

        def timed_copy(*a, **k):
            rec.ckpt.wait()
            t = time.perf_counter()
            take(*a, **k)
            copies.append(time.perf_counter() - t)
        rec.ckpt.save = timed_copy
        drive(rec)
        rec.wal.append_regrow(rec.engine.tier + 1)   # logged, not applied
        rec.wait()
        gen = ckpt.latest_step(tmp)
        del rec                                      # the crash
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        rec2 = RecoverableEngine.restore(tmp, cfg, params, guard=guard,
                                         device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        need(rec2.engine.tier == 1, "recovery: the logged regrow did not run")
        need(digest(state_leaves(rec2.engine.state)) == want,
             "recovery: restored state != the uninterrupted run's")
        need(torch.equal(rec2.walk(starts).cpu(), want_paths),
             "recovery: the next walk batch != the uninterrupted run's")
        del rec2
    finally:
        ckpt.save_checkpoint = save
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    snap_gib = sum(x.numel() * x.element_size() for x in state_leaves(
        dg.empty_state(cfg, "meta")) if x is not None) / 2**30
    out = {"scale": scale, "rounds": rounds, "batch": batch,
           "snapshot_gib": snap_gib, "snapshot_copy_s": copies,
           "snapshot_write_s": writes, "restored_from_generation": gen,
           "restore_s": restore_s,
           "phase_s": time.perf_counter() - t_phase}
    report["recovery"] = out
    print(f"recovery: 2^{scale} vertices, {rounds} guarded rounds of {batch} "
          f"and walks through RecoverableEngine(checkpoint_every=3), a regrow "
          f"record logged and the engine dropped before it migrates: restore "
          f"from generation {gen} + WAL replay {restore_s:.2f} s, state and "
          f"next walk batch equal to the uninterrupted run; snapshots "
          f"({snap_gib:.2f} GiB) host copy {[round(x, 3) for x in copies]} s, "
          f"write {[round(x, 3) for x in writes]} s; phase "
          f"{out['phase_s']:.1f} s", flush=True)


# --------------------------------------------------------------- phase 3g
def array_digest(a):
    """SHA-256 of an array's bytes (its shape and type too)."""
    a = np.ascontiguousarray(a)
    return hashlib.sha256(f"{a.shape}{a.dtype}".encode()
                          + a.tobytes()).hexdigest()


def op_digest(op):
    """An admission-trace op as one digest (the same for equal ops)."""
    name = type(op).__name__
    if name == "UpdateOp":
        return name + ":" + hashlib.sha256("".join(
            array_digest(x) for x in op[:4]).encode()
            + str(op.n_valid).encode()).hexdigest()
    if name == "WalkOp":
        return name + ":" + array_digest(op.starts) + str(op.rids) \
            + str(op.sizes)
    return f"{name}:{op[0]}"


def books_digest(snap):
    """SHA-256 of a guard ``snapshot()``."""
    return hashlib.sha256(json.dumps(snap, sort_keys=True).encode()) \
        .hexdigest()


def sharded_serving_phase(report, handoff, card):
    """Phase 3g: phase 3f's traffic through a guarded 4-rank engine on
    gloo, chaos relays on its grown state, then one NCCL rank's deferred
    window under ``set_sync_debug_mode("error")`` (module docstring).
    Returns the phase's launches by kernel."""
    import torch
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    try:
        (tmp / "handoff.pkl").write_bytes(pickle.dumps(handoff))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        gloo = spawn_ranks(tmp, "gloo", SHARDS, serve_rank,
                           SERVE_SHARD_TIMEOUT_S)
        t_gloo = time.perf_counter() - t0
        nccl = spawn_ranks(tmp, "nccl", 1, serve_rank, SERVE_SHARD_TIMEOUT_S)
        t_nccl = time.perf_counter() - t0 - t_gloo
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for key in ("rounds_per_cohort", "regrows", "chaos_rounds"):
        need(len({json.dumps(g[key]) for g in gloo}) == 1,
             f"sharded serving: ranks disagree on {key}")
    g0 = gloo[0]
    lat = sorted(x for g in gloo for x in g["latency_ms"])
    out = {"gloo_s": t_gloo, "nccl_s": t_nccl, "ranks": gloo,
           "nccl": nccl[0], "live": g0["live"]}
    if lat:
        out["latency_p50_ms"] = lat[len(lat) // 2]
        out["latency_p99_ms"] = lat[min(len(lat) - 1,
                                        int(math.ceil(0.99 * len(lat))) - 1)]
    live_s = max(g["live_s"] for g in gloo)
    out["walk_steps_per_s"] = g0["walk_steps"] / live_s
    out["updates_per_s"] = g0["updates"] / live_s
    cls = [g["classify_ms"] for g in gloo]
    med = [statistics.median(c) for c in cls]
    print(f"{card}: sharded serving (S={SHARDS}, gloo; "
          f"{'live scheduler, trace equal to phase 3f' if g0['live'] else 'phase 3f trace replayed (3f dispatch met max_inflight)'}): "
          f"{g0['windows']} update windows, {g0['retry_rounds']} retry rounds, "
          f"{len(g0['rounds_per_cohort'])} cohorts, regrow counts "
          f"{g0['regrows']}; requests, guard books, regrow counts, slices "
          f"equal to phase 3f's single device", flush=True)
    if lat:
        print(f"{card}: sharded serving request latency p50 "
              f"{out['latency_p50_ms']:.1f} ms, p99 {out['latency_p99_ms']:.1f} "
              f"ms (single device {handoff['latency'][0]:.1f} / "
              f"{handoff['latency'][1]:.1f})", flush=True)
    print(f"{card}: sharded serving {out['walk_steps_per_s'] / 1e6:.2f} M walk "
          f"steps/s, {out['updates_per_s'] / 1e6:.3f} M updates/s over "
          f"{live_s:.2f} s (slowest rank, host clock)", flush=True)
    for r, g in enumerate(gloo):
        m = g["migration"]
        print(f"{card}: rank {r}: drains "
              + ", ".join(f"{d['rounds']} rounds at tier {d['tier']} "
                          f"{d['ms']:.1f} ms" for d in g["drains"])
              + f"; migration 256 -> 512 {m['ms']:.2f} ms (CUDA events; "
              f"{m['wall_ms']:.2f} ms host; single device "
              f"{handoff['migration_ms']:.2f} ms); classifier with its "
              f"all_reduce median {med[r]:.3f} ms a window (min "
              f"{min(cls[r]):.3f}, max {max(cls[r]):.3f}; host median "
              f"{statistics.median(g['classify_host_ms']):.3f} ms)",
              flush=True)
    print(f"{card}: sharded serving relay rounds per cohort "
          f"{g0['rounds_per_cohort']} (bulk rounds; walk_segment launches "
          f"{g0['launches']['walk_segment']} a rank, update_fused "
          f"{g0['launches']['update_fused']})", flush=True)
    for name, rep in g0["chaos"].items():
        print(f"{card}: chaos {name}: {rep}", flush=True)
    n1 = nccl[0]
    print(f"{card}: S=1 over NCCL: deferred guarded window of "
          f"{n1['lanes']} lanes under set_sync_debug_mode('error'), its "
          f"classifier, all_reduces and update round: no host sync; "
          f"{n1['ms']:.3f} ms (CUDA events), books conserved", flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"{card}: sharded serving phase {out['phase_s']:.1f} s (gloo ranks "
          f"{t_gloo:.1f} s, nccl rank {t_nccl:.1f} s)", flush=True)
    report["sharded_serving"] = out
    launches = {"walk_segment": 0, "update_fused": 0}
    for g in gloo + nccl:
        for k in launches:
            launches[k] += g["launches"].get(k, 0) \
                + g.get("chaos_launches", {}).get(k, 0)
    return launches


def serve_rank(rank, n, backend, tmp):
    """One rank of phase 3g (runs in its own process)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import dyngraph as dg
    from repro_torch.core.walks import WalkParams
    from repro_torch.serve import DynamicWalkEngine, GuardPolicy
    tmp = Path(tmp)
    torch.cuda.set_device(0)
    dist.init_process_group(
        backend, store=dist.FileStore(str(tmp / f"store_{backend}"), n),
        rank=rank, world_size=n, timeout=datetime.timedelta(seconds=120),
        device_id=torch.device("cuda", 0) if backend == "nccl" else None)
    group = dist.group.WORLD
    try:
        h = pickle.loads((tmp / "handoff.pkl").read_bytes())
        cfg = dg.BingoConfig(num_vertices=h["V"], capacity=SERVE_LADDER[0],
                             bias_bits=16, capacity_ladder=SERVE_LADDER)
        engine = None
        for r in range(n):           # build in turn: one whole state at a time
            if r == rank:
                st = dg.from_edges(cfg, *h["init"], device="cuda")
                engine = DynamicWalkEngine(
                    st, cfg, WalkParams("deepwalk", WALK_LEN),
                    seed=SERVE_SEED,
                    guard=GuardPolicy(retry_batch=SERVE_RETRY_BATCH),
                    walk_buckets=SERVE_WALK_BUCKETS, group=group,
                    relay_overlap=False)
                del st
                torch.cuda.empty_cache()
            dist.barrier()
        res = nccl_window(engine, h) if backend == "nccl" else \
            gloo_serving(engine, h, rank)
        dist.barrier()
        (tmp / f"result_{backend}_{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def nccl_window(engine, h):
    """Phase 3f's first two windows on a sharded engine of one NCCL rank,
    deferred; the second under ``set_sync_debug_mode("error")``, with the
    classifier's and the stats' ``all_reduce``s in place."""
    import torch
    from repro_torch.kernels import ops
    engine.defer_guard = True
    first, second = h["windows"]
    engine.ingest(first.is_insert, first.u, first.v, first.w,
                  n_valid=first.n_valid)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine.ingest(second.is_insert, second.u, second.v, second.w,
                      n_valid=second.n_valid)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    b.record()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    need(counts["update_fused"] == 1, f"nccl window: launches {counts}")
    need(engine.drain_guard() == 2, "nccl window: backlog")
    engine.guard.check_conservation()
    return {"ms": a.elapsed_time(b), "lanes": int(second.n_valid),
            "launches": counts}


def gloo_serving(engine, h, rank, raising=True):
    """Phase 3f's traffic through the scheduler on this rank's engine (a
    process group's or a mesh's; or, if phase 3f's dispatch met
    ``max_inflight``, its trace replayed), the checks against phase 3f's
    digests, then the chaos relays: dup + delay, and with ``raising`` a
    drop and a killed transport."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.backend import get_backend
    from repro_torch.core.invariants import DEVICE_RULES
    from repro_torch.core.walks import WalkParams
    from repro_torch.distributed.chaos import (ChaosSchedule,
                                               RelayIntegrityError,
                                               run_chaos_relay)
    from repro_torch.kernels import ops
    from repro_torch.serve.scheduler import (SchedulerConfig,
                                             ServingScheduler, UpdateOp,
                                             WalkOp, replay_admission_trace)
    res = {"classify_ms": [], "classify_host_ms": [], "drains": [],
           "rounds_per_cohort": [], "live": h["timing_free"]}
    g = engine.guard

    def wrap_classify():
        inner, regrow = g.classify, g.regrow

        def classify(*a):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            r = inner(*a)
            e1.record()
            res["classify_host_ms"].append((time.perf_counter() - t0) * 1e3)
            events.append((e0, e1))
            return r

        def regrow_(cfg_next):
            regrow(cfg_next)
            wrap_classify()
        g.classify, g.regrow = classify, regrow_
    events = []
    wrap_classify()
    walk, drain, migrate = engine.walk, engine.drain_guard, engine._migrate

    def walk_(*a, **k):
        out = walk(*a, **k)
        res["rounds_per_cohort"].append(engine.last_relay["rounds"])
        return out

    def drain_():
        t0 = time.perf_counter()
        k = drain()
        if k:
            res["drains"].append({"rounds": k, "tier": engine.tier,
                                  "ms": (time.perf_counter() - t0) * 1e3})
        return k

    def migrate_():
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        migrate()
        b.record()
        torch.cuda.synchronize()
        res["migration"] = {"ms": a.elapsed_time(b),
                            "wall_ms": (time.perf_counter() - t0) * 1e3}
    engine.walk, engine.drain_guard, engine._migrate = walk_, drain_, migrate_

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    if h["timing_free"]:
        sched = ServingScheduler(engine, SchedulerConfig(**h["sched_cfg"]))
        results = {}
        for burst in h["bursts"]:
            for kind, x in burst:
                if kind == "update":
                    need(sched.submit_update(*h["updates"][x]),
                         "update refused")
                else:
                    need(sched.submit_walk(x) is not None, "walk refused")
            sched.tick()
            results.update((r.rid, r) for r in sched.poll())
        results.update((r.rid, r) for r in sched.close())
        trace = sched.trace
        need([op_digest(op) for op in trace] == h["trace"],
             f"rank {rank}: admission trace != phase 3f's")
        sched.check_conservation()
        paths = {rid: r.paths for rid, r in results.items()}
        res["latency_ms"] = [r.latency_s * 1e3 for r in results.values()]
    else:
        trace = h["trace_ops"]
        paths = {}
        for op, rows in zip([op for op in trace if isinstance(op, WalkOp)],
                            replay_admission_trace(engine, trace)):
            off = np.cumsum([0] + list(op.sizes))
            for j, rid in enumerate(op.rids):
                paths[rid] = rows[off[j]:off[j + 1]]
        res["latency_ms"] = []
    torch.cuda.synchronize()
    res["live_s"] = time.perf_counter() - t0
    counts = ops.launch_counts()
    n_upd = sum(isinstance(op, UpdateOp) for op in trace)
    need(counts["walk_segment"] == sum(res["rounds_per_cohort"]) and
         counts["update_fused"] == n_upd + engine.retry_rounds and
         sum(counts.values()) == counts["walk_segment"]
         + counts["update_fused"],
         f"rank {rank}: launches {counts}")
    need(paths.keys() == h["paths"].keys() and all(
        array_digest(p) == h["paths"][rid] for rid, p in paths.items()),
         f"rank {rank}: a request's paths != phase 3f's")
    g.check_conservation()
    need(books_digest(g.snapshot()) == h["guard"],
         f"rank {rank}: guard books != phase 3f's")
    need(list(engine.regrow_counts) == list(h["regrow_counts"]) and
         engine.tier == h["tier"] and engine.retry_rounds == h["retry_rounds"],
         f"rank {rank}: regrows {engine.regrow_counts}, retry rounds "
         f"{engine.retry_rounds}")
    Vs = engine.shard_size
    need(slice_digest(engine.state, 0, Vs)
         == h["slices"][engine.num_shards][engine.rank],
         f"rank {rank}: final slice != phase 3f's")
    audit = engine.audit(pressure=True)
    need(not any(audit[k] for k in DEVICE_RULES if k != "at_capacity"),
         f"rank {rank}: audit {audit}")
    torch.cuda.synchronize()
    res["classify_ms"] = [a.elapsed_time(b) for a, b in events]
    res.update(windows=n_upd, retry_rounds=engine.retry_rounds,
               regrows=list(engine.regrow_counts), launches=counts,
               walk_steps=sum(int((p[:, 1:] >= 0).sum())
                              for p in paths.values()),
               updates=sum(op.n_valid for op in trace
                           if isinstance(op, UpdateOp)))

    # chaos on the grown state
    bk = get_backend("fused")
    params = WalkParams("deepwalk", WALK_LEN)
    c = h["chaos"]
    starts = torch.from_numpy(c["starts"]).cuda()
    layout = dict(mesh=engine.mesh, walker_axes=engine.walker_axes)
    res["chaos"], res["chaos_rounds"] = {}, []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    p, rep = run_chaos_relay(bk, engine.cfg, params, engine.group,
                             engine.state, starts, c["seed"],
                             ChaosSchedule(seed=2, dup=0.2, delay=0.2),
                             **layout)
    need(digest([p]) == c["all"] and rep.lost == 0 and
         rep.pending_at_exit == 0 and rep.duplicated > 0 and rep.delayed > 0,
         f"rank {rank}: chaos dup+delay {rep}")
    res["chaos"]["dup=0.2 delay=0.2"] = dict(dataclasses.asdict(rep),
                                             wall_s=time.perf_counter() - t0)
    res["chaos_rounds"].append(rep.rounds)
    del p
    for name, sched, max_rounds, what in (
            ("drop=0.01", ChaosSchedule(seed=3, drop=0.01), None, "lost"),
            ("kill_round=3", ChaosSchedule(seed=4, kill_round=3),
             CHAOS_KILL_ROUNDS, "pending_at_exit"))[:2 if raising else 0]:
        t0 = time.perf_counter()
        try:
            run_chaos_relay(bk, engine.cfg, params, engine.group,
                            engine.state, starts, c["seed"], sched,
                            max_rounds=max_rounds, **layout)
            need(False, f"rank {rank}: chaos {name} did not raise")
        except RelayIntegrityError as e:
            need(getattr(e.report, what) > 0,
                 f"rank {rank}: chaos {name}: {e.report}")
            res["chaos"][name] = dict(dataclasses.asdict(e.report),
                                      wall_s=time.perf_counter() - t0)
            res["chaos_rounds"].append(e.report.rounds)
    torch.cuda.synchronize()
    res["chaos_launches"] = ops.launch_counts()
    need(res["chaos_launches"]["walk_segment"] == sum(res["chaos_rounds"]),
         f"rank {rank}: chaos launches {res['chaos_launches']}")
    return res


# --------------------------------------------------------------- phase 3h
def mesh_phase(report, mesh_h, serve_h, starts, stream, card):
    """Phase 3h: the 2D vertex x walker mesh (module docstring): 4 gloo
    ranks as a ``MESH_SHAPE`` ``DeviceMesh``, then the comparison samplers
    in this process.  Returns the ranks' launches by kernel."""
    import torch
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    try:
        np.savez(tmp / "inputs.npz", **stream._asdict(),
                 starts=starts.cpu().numpy())
        main_h = {k: mesh_h[k] for k in ("V", "round_stats", "slices",
                                         "walks")}
        (tmp / "handoff.pkl").write_bytes(pickle.dumps(
            {"main": main_h, "serve": serve_h}))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = spawn_ranks(tmp, "gloo", SHARDS, mesh_rank, MESH_TIMEOUT_S)
        t_ranks = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for g in ranks:
        g["counts"] = [(b["rounds"], b["overflow"], b["peak_slots"])
                       for b in g["relays"]]
    for key in ("counts", "rounds_per_cohort", "regrows", "chaos_rounds"):
        need(len({json.dumps(g[key]) for g in ranks}) == 1,
             f"mesh: ranks disagree on {key}")
    g0 = ranks[0]
    pool = slot_count_2d(len(starts))
    out = {"ranks_s": t_ranks, "pool_slots": pool, "ranks": ranks}
    print(f"{card}: mesh {MESH_SHAPE} {MESH_DIMS}, walker axes "
          f"{WALKER_AXES}: rank -> (vertex, walker group) "
          + ", ".join(f"{r}: ({g['place'][0]}, {g['place'][1]})"
                      for r, g in enumerate(ranks))
          + f"; main path's 10 rounds: stats and slices equal to the single "
          f"device on every rank ({g0['ingest_ms']:.1f} ms of ingest a rank)",
          flush=True)
    for i, b in enumerate(g0["relays"]):
        exch = [r["relays"][i]["exchange_ms"] for r in ranks]
        print(f"{card}: mesh relay {b['name']} ({len(starts)} walkers, "
              f"{len(starts) // MESH_SHAPE[1]} a group): {b['rounds']} "
              f"rounds, "
              f"overflow {b['overflow']}, peak slots {b['peak_slots']} of a "
              f"group's pool of {pool} (slot_count({len(starts) // 2}, 2)), "
              f"wall {max(r['relays'][i]['wall_s'] for r in ranks):.3f} s "
              f"(slowest rank); exchange ms a round, median by rank "
              + ", ".join(f"{statistics.median(e):.2f}" for e in exch)
              + f"; walk_segment {b['launches']} launches a rank; stitched "
              f"paths equal to the single-device walk", flush=True)
        need(b["peak_slots"] <= pool, f"mesh relay {b['name']}: peak "
             f"{b['peak_slots']} > {pool}")
    lat = sorted(x for g in ranks for x in g["latency_ms"])
    if lat:
        out["latency_p50_ms"] = lat[len(lat) // 2]
        out["latency_p99_ms"] = lat[min(len(lat) - 1,
                                        int(math.ceil(0.99 * len(lat))) - 1)]
    live_s = max(g["live_s"] for g in ranks)
    out["walk_steps_per_s"] = g0["walk_steps"] / live_s
    out["updates_per_s"] = g0["updates"] / live_s
    how = "live scheduler, trace equal to phase 3f's" if g0["live"] \
        else "phase 3f's trace replayed (its dispatch met max_inflight)"
    print(f"{card}: mesh serving ({how}): "
          f"{g0['windows']} update windows, {g0['retry_rounds']} retry "
          f"rounds, {len(g0['rounds_per_cohort'])} cohorts of "
          f"{min(g0['rounds_per_cohort'])}-{max(g0['rounds_per_cohort'])} "
          f"bulk rounds, regrow counts {g0['regrows']}; requests, guard "
          f"books, regrow counts equal to phase 3f's, each rank's slice "
          f"phase 3f's rows of its vertex index (both replicas); "
          + (f"request latency p50 {out['latency_p50_ms']:.1f} ms, p99 "
             f"{out['latency_p99_ms']:.1f} ms; " if lat else "")
          + f"{out['walk_steps_per_s'] / 1e6:.2f} M walk steps/s, "
          f"{out['updates_per_s'] / 1e6:.3f} M updates/s over {live_s:.2f} s",
          flush=True)
    for r, g in enumerate(ranks):
        m = g["migration"]
        print(f"{card}: mesh rank {r}: migration 256 -> 512 {m['ms']:.2f} ms "
              f"(CUDA events); classifier with its all_reduce median "
              f"{statistics.median(g['classify_ms']):.3f} ms a window; "
              f"update_fused {g['launches']['update_fused']}, walk_segment "
              f"{g['launches']['walk_segment']} launches", flush=True)
    for name, rep in g0["chaos"].items():
        print(f"{card}: mesh chaos {name}: {rep}", flush=True)
    t1 = time.perf_counter()
    out["baselines"] = baseline_phase(report, mesh_h, starts, card)
    out["baselines_s"] = time.perf_counter() - t1
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"{card}: mesh phase {out['phase_s']:.1f} s (ranks {t_ranks:.1f} "
          f"s, baselines {out['baselines_s']:.1f} s)", flush=True)
    report["mesh"] = out
    launches = {"walk_segment": 0, "update_fused": 0}
    for g in ranks:
        for k in launches:
            launches[k] += g["main_launches"].get(k, 0) \
                + g["launches"].get(k, 0) \
                + g.get("chaos_launches", {}).get(k, 0)
    return launches


def slot_count_2d(W):
    """One walker group's pool: ``slot_count(W / S_w, S_v)``."""
    from repro_torch.distributed.relay import slot_count
    return slot_count(W // MESH_SHAPE[1], MESH_SHAPE[0])


def mesh_rank(rank, n, backend, tmp):
    """One rank of phase 3h (runs in its own process)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import dyngraph as dg
    from repro_torch.core.walks import WalkParams
    from repro_torch.serve import DynamicWalkEngine, GuardPolicy
    tmp = Path(tmp)
    torch.cuda.set_device(0)
    dist.init_process_group(
        backend, store=dist.FileStore(str(tmp / f"store_{backend}"), n),
        rank=rank, world_size=n, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = init_device_mesh("cuda", MESH_SHAPE, mesh_dim_names=MESH_DIMS)
        layout = dict(mesh=mesh, walker_axes=WALKER_AXES)
        h = pickle.loads((tmp / "handoff.pkl").read_bytes())
        m, sh = h["main"], h["serve"]
        data = np.load(tmp / "inputs.npz")
        V = m["V"]
        cfg = dg.BingoConfig(num_vertices=V, capacity=256, bias_bits=16)
        scfg = dg.BingoConfig(num_vertices=V, capacity=SERVE_LADDER[0],
                              bias_bits=16, capacity_ladder=SERVE_LADDER)
        params = WalkParams("deepwalk", WALK_LEN)
        for r in range(n):           # build in turn: one whole state at a time
            if r == rank:            # (phase 3f's initial state is the main
                st = dg.from_edges(  # path's: the same edges and widths)
                    cfg, data["init_src"], data["init_dst"], data["init_w"],
                    device="cuda")
                main = DynamicWalkEngine(st, cfg, params, **layout)
                serve = DynamicWalkEngine(
                    st, scfg, params, seed=SERVE_SEED,
                    guard=GuardPolicy(retry_batch=SERVE_RETRY_BATCH),
                    walk_buckets=SERVE_WALK_BUCKETS, relay_overlap=False,
                    **layout)
                del st
                torch.cuda.empty_cache()
            dist.barrier()
        res = {"place": (main.rank, main.walker_group)}
        res.update(mesh_relays(main, m, data, rank))
        del main
        torch.cuda.empty_cache()
        res.update(gloo_serving(serve, sh, rank, raising=False))
        dist.barrier()
        (tmp / f"result_{backend}_{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def mesh_relays(engine, m, data, rank):
    """Part 1 of phase 3h on this rank: the main path's 10 rounds through
    the 2D engine (stats and slice equal to the single device), then its
    relays (``MESH_BATCHES``), each rank's stitched paths equal to the
    single-device walk, launches equal to the rounds."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.backend import get_backend
    from repro_torch.core.walks import WalkParams
    from repro_torch.distributed.relay import make_relay, stitch
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r, want in enumerate(m["round_stats"]):
        lanes = [torch.from_numpy(np.ascontiguousarray(data[k][r])).cuda()
                 for k in ("is_insert", "u", "v", "w")]
        got = stats_list(engine.ingest(*lanes))
        need(got == want, f"mesh rank {rank}: round {r + 1} stats {got} != "
             f"single-device {want}")
    torch.cuda.synchronize()
    ingest_ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    need(counts["update_fused"] == len(m["round_stats"]),
         f"mesh rank {rank}: ingest launches {counts}")
    need(slice_digest(engine.state, 0, engine.shard_size)
         == m["slices"][engine.rank],
         f"mesh rank {rank}: slice after the rounds != single device")
    starts = torch.from_numpy(data["starts"]).cuda()
    bk = get_backend("fused")
    layout = dict(mesh=engine.mesh, walker_axes=engine.walker_axes)
    relays = []
    for kind, overlap in MESH_BATCHES:
        params = WalkParams(kind, WALK_LEN)
        seed = m["walks"][kind]["seed"]
        trace = []
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        if overlap:                      # through the engine
            engine.relay_trace = trace
            paths = engine.walk(starts, seed, stitch=True)
            engine.relay_trace = None
            rounds, ovf, peak = (engine.last_relay[k] for k in
                                 ("rounds", "overflow", "peak_slots"))
        else:
            run = make_relay(bk, engine.cfg, params, overlap=False,
                             diagnostics=True, **layout)
            home, rounds, ovf, peak = run(engine.state, starts, seed,
                                          trace=trace)
            paths = stitch(home, **layout)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = ops.launch_counts()
        name = f"{kind} {'overlapped' if overlap else 'bulk'}"
        need(c["walk_segment"] == rounds and sum(c.values()) == rounds,
             f"mesh rank {rank} {name}: launches {c}, rounds {rounds}")
        need(digest([paths]) == m["walks"][kind]["all"],
             f"mesh rank {rank} {name}: stitched paths != single device")
        relays.append({"name": name, "rounds": rounds, "overflow": ovf,
                       "peak_slots": peak, "wall_s": wall,
                       "launches": c["walk_segment"],
                       "exchange_ms": [1e3 * x["exchange_s"] for x in trace],
                       "reduce_ms": [1e3 * x["reduce_s"] for x in trace]})
        del paths
    return {"relays": relays, "ingest_ms": ingest_ms,
            "main_launches": {"update_fused": len(m["round_stats"]),
                              "walk_segment": sum(b["launches"]
                                                  for b in relays)}}


def baseline_phase(report, mesh_h, starts, card):
    """Part 4 of phase 3h: the comparison samplers (``core/baselines.py``)
    on the main path's final edges at its widths: build, one step of
    every start, ``BASELINE_UPDATES`` inserts and deletes through each,
    then the touched alias rows against a fresh build, the ITS prefix
    sums against a fresh cumulative sum and ``wmax`` against the rows'
    maxima.  Times beside B4a's one step at the same starts, this run."""
    import torch
    from repro_torch.core import baselines as bl
    from repro_torch.core.alias import build_alias
    src, dst, w = mesh_h["edges"]
    V, C = mesh_h["V"], 256
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    adj = bl.adj_from_edges(V, C, src, dst, w.astype(np.float32),
                            device="cuda")
    torch.cuda.synchronize()
    adj_s = time.perf_counter() - t0
    rng = np.random.default_rng(BASELINE_SEED)
    deg = adj.deg.cpu().numpy()
    ins_u = rng.choice(np.flatnonzero(deg < C), BASELINE_UPDATES,
                       replace=False)
    ins = [(int(u), int(rng.integers(0, V)), float(rng.integers(1, 1 << 16)))
           for u in ins_u]
    pick = rng.choice(len(src), BASELINE_UPDATES, replace=False)
    dels = [(int(src[k]), int(dst[k])) for k in pick]
    touched = torch.tensor(sorted({u for u, _, _ in ins}
                                  | {u for u, _ in dels}), device="cuda")
    b4a = report["walk_sample"]["ms"]
    out = {"adj_s": adj_s, "b4a_ms": b4a, "updates": 2 * BASELINE_UPDATES}
    updated_adj = None
    for name in ("AliasBaseline", "ITSBaseline", "RejectionBaseline",
                 "ReservoirBaseline"):
        cls = getattr(bl, name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = cls.build(adj)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        gen = torch.Generator(device="cuda").manual_seed(BASELINE_SEED)
        ms, nxt = cuda_ms(partial(b.sample, starts, gen))
        rows = adj.nbr[starts.long()]
        ok = (rows == nxt[:, None]).any(1) | (adj.deg[starts.long()] == 0)
        need(bool(ok.all()), f"{name}: a draw off its row")
        upd = []
        for (u, v, ww), (du, dv) in zip(ins, dels):
            for op, args in (("insert", (u, v, ww)), ("delete", (du, dv))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                b = getattr(b, op)(*args)
                torch.cuda.synchronize()
                upd.append((time.perf_counter() - t0) * 1e3)
        if updated_adj is None:
            updated_adj = b.adj
        else:
            need(all(torch.equal(x, y) for x, y in zip(b.adj, updated_adj)),
                 f"{name}: the updated adjacency differs")
        valid_all = None
        if name == "AliasBaseline":
            fresh = build_alias(bl._valid_w(b.adj, touched))
            need(torch.equal(b.table.prob[touched], fresh.prob) and
                 torch.equal(b.table.alias[touched], fresh.alias),
                 "AliasBaseline: a touched row != a fresh build")
        elif name == "ITSBaseline":
            valid_all = bl._valid_w(b.adj, torch.arange(V, device="cuda"))
            need(torch.equal(b.cdf, torch.cumsum(valid_all, dim=-1)),
                 "ITSBaseline: prefix sums != a fresh cumulative sum")
        elif name == "RejectionBaseline":
            need(torch.equal(b.wmax[touched], bl._valid_w(
                b.adj, touched).max(-1).values),
                "RejectionBaseline: wmax != the touched rows' maxima")
        del valid_all
        upd.sort()
        out[name] = {"build_s": build_s, "step_ms": ms,
                     "update_ms_median": upd[len(upd) // 2],
                     "update_ms_max": upd[-1]}
        print(f"{card}: baseline {name}: build {build_s:.3f} s; one step of "
              f"{len(starts)} walkers {ms:.4f} ms ({ms / b4a:.1f}x B4a's "
              f"{b4a:.4f} ms, this run); {len(upd)} updates, median "
              f"{upd[len(upd) // 2]:.2f} ms (max {upd[-1]:.2f})", flush=True)
        del b
        torch.cuda.empty_cache()
    out["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    print(f"{card}: baselines on the main path's final edges (V {V}, C {C}, "
          f"adjacency {adj_s:.2f} s to build, {int(deg.sum())} edges): draws "
          f"on their rows; the touched alias rows a fresh build's, the ITS "
          f"sums a fresh cumulative sum, wmax the rows' maxima; peak "
          f"{out['peak_gib']:.1f} GiB", flush=True)
    report["baselines"] = out
    return out


# --------------------------------------------------------------- phase 3i
# phase 3i: examples/graph_serve.py's walk-grounded loop at qwen2-0.5b's
# full width (configs/qwen2_0_5b.py: every vertex id of the 2^17-vertex
# graph is a token id of its 151,936-word vocabulary)
LM_ARCH = "qwen2-0.5b"
LM_SCALE, LM_CAPACITY, LM_BITS = 17, 256, 8
LM_SLOTS, LM_MAX_LEN, LM_NEW = 8, 64, 8
LM_WAVES, LM_REQUESTS, LM_WALK_LEN, LM_PROMPT = 2, 16, 12, 16
LM_UPDATES = 4096                   # inserts in the round between waves
LM_CHECK_LEN = 32                   # decode vs forward: prompt tokens
# float32 logits, decode against forward (and ragged against dense MoE):
# max |a - b| <= LM_F32_TOL * max |forward|
LM_F32_TOL = 1e-4
# bfloat16 logits against the float32 forward: decode's error at most
# twice forward's, plus one bf16 step (2^-7) of the logits' scale
LM_BF16_STEP = 2.0 ** -7
# SMOKE configs in float32: decode against forward on the card
# (tests/test_models.py's largest atol)
LM_SMOKE_ATOL = 2e-4
# float32 logits of the same params on the card and on the CPU: max |a - b|
# <= tol * max |cpu|, tol LM_F32_TOL but for xlstm-350m: its mLSTM blocks
# divide by max(|sum W|, e^-m), near zero at random init, which amplifies
# each op's rounding (1.24e-4 on logits of scale ~2 on an H100)
LM_CPU_TOL = {"xlstm-350m": 1e-3}


def lm_cpu_limit(arch, want):
    """The largest |card - cpu| allowed for logits ``want`` of ``arch``."""
    return LM_CPU_TOL.get(arch, LM_F32_TOL) * float(want.abs().max())


def lm_logits_decode(params, cfg, tokens):
    """(B, S, V) float32 logits of ``decode_step`` fed ``tokens`` (B, S)
    one position at a time, into a float32 cache as the engine keeps it."""
    import torch
    from repro_torch.models import decode_step, init_decode_cache
    B, S = tokens.shape
    cache = init_decode_cache(cfg, B, S, dtype=torch.float32,
                              device=tokens.device)
    out = []
    for t in range(S):
        lg, cache = decode_step(params, cfg, tokens[:, t], torch.full(
            (B,), t, dtype=torch.int32, device=tokens.device), cache)
        out.append(lg)
    return torch.stack(out, 1)


def lm_bf16_check(name, params, cfg, tokens):
    """Decode against forward for a bfloat16 config, each held against the
    float32 forward of the same params; and float32 decode against float32
    forward.  Returns the errors."""
    import torch
    from repro_torch.models import forward
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    batch = {"inputs": tokens}
    fwd32 = forward(params, cfg32, batch)[0]
    fwd16 = forward(params, cfg, batch)[0]
    dec16 = lm_logits_decode(params, cfg, tokens)
    dec32 = lm_logits_decode(params, cfg32, tokens)
    for x in (fwd16, dec16, dec32):
        need(x.shape == fwd32.shape and bool(torch.isfinite(x).all()),
             f"{name}: logits")
    scale = float(fwd32.abs().max())
    e = {"scale": scale,
         "fwd16": float((fwd16 - fwd32).abs().max()),
         "dec16": float((dec16 - fwd32).abs().max()),
         "dec16_fwd16": float((dec16 - fwd16).abs().max()),
         "dec32": float((dec32 - fwd32).abs().max())}
    e["bf16_limit"] = 2 * e["fwd16"] + LM_BF16_STEP * scale
    e["f32_limit"] = LM_F32_TOL * scale
    e["argmax_agree"] = float((dec16.argmax(-1) == fwd16.argmax(-1))
                              .float().mean())
    print(f"{name}: logits scale {scale:.4f}; bf16 forward vs f32 "
          f"{e['fwd16']:.3e}, bf16 decode vs f32 {e['dec16']:.3e} (limit "
          f"{e['bf16_limit']:.3e}), bf16 decode vs bf16 forward "
          f"{e['dec16_fwd16']:.3e} (argmax equal at {e['argmax_agree']:.3f} "
          f"of positions); f32 decode vs f32 forward {e['dec32']:.3e} "
          f"(limit {e['f32_limit']:.3e})", flush=True)
    need(e["dec16"] <= e["bf16_limit"], f"{name}: bf16 decode vs forward")
    need(e["dec32"] <= e["f32_limit"], f"{name}: f32 decode vs forward")
    return e


def lm_smoke_checks(report):
    """Every registry arch but qwen2-0.5b at its SMOKE config (float32),
    params drawn on the CPU and copied to the card: forward on the card
    against the CPU, and (decoders) decode against forward on the card
    and the card's decode against the CPU's."""
    import torch
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models import forward, init_model
    out = {}
    for i, arch in enumerate(ARCHS):
        if arch == LM_ARCH:
            continue
        cfg = smoke_config(arch)
        cpu = init_model(cfg, torch.Generator().manual_seed(100 + i))
        dev = lm_tree(cpu, lambda t: t.to("cuda"))
        g = torch.Generator().manual_seed(200 + i)
        tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
        batch = {"inputs": tokens}
        if cfg.frontend != "none":
            batch["embeddings"] = torch.randn((2, 16, cfg.d_model),
                                              generator=g)
        want = forward(cpu, cfg, batch)[0]
        got = forward(dev, cfg, {k: v.to("cuda")
                                 for k, v in batch.items()})[0]
        e = {"cpu_fwd": float((got.cpu() - want).abs().max())}
        need(e["cpu_fwd"] <= lm_cpu_limit(arch, want),
             f"{arch}: forward card != cpu ({e['cpu_fwd']:.3e})")
        if cfg.frontend == "none" and not cfg.encoder_only:
            dec = lm_logits_decode(dev, cfg, tokens.to("cuda"))
            dec_cpu = lm_logits_decode(cpu, cfg, tokens)
            e["dec_fwd"] = float((dec - got).abs().max())
            e["cpu_dec"] = float((dec.cpu() - dec_cpu).abs().max())
            need(e["dec_fwd"] <= LM_SMOKE_ATOL,
                 f"{arch}: decode vs forward on the card {e['dec_fwd']:.3e}")
            need(e["cpu_dec"] <= lm_cpu_limit(arch, dec_cpu),
                 f"{arch}: decode card != cpu ({e['cpu_dec']:.3e})")
        out[arch] = e
    print("SMOKE configs on the card (f32): " + "; ".join(
        f"{a} " + ", ".join(f"{k} {v:.1e}" for k, v in e.items())
        for a, e in out.items()), flush=True)
    report["smoke"] = out


def lm_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: lm_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def lm_phase(report, card):
    """Phase 3i: the LM serving path (module docstring).  Returns the
    walk-grounded loop's launches by kernel."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import walks
    from repro_torch.core.dyngraph import BingoConfig, from_edges
    from repro_torch.core.updates import batched_update, make_updater
    from repro_torch.graph.rmat import degree_bias, rmat_edges
    from repro_torch.kernels import ops
    from repro_torch.kernels.update_fused import plan_round
    from repro_torch.kernels.walk_fused import walk_fused_ref
    from repro_torch.models import forward, init_model
    from repro_torch.serve import DecodeEngine, ServeRequest
    out = report["lm"] = {}
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()

    # ---- 1. walk-grounded serving at full width
    V = 1 << LM_SCALE
    src, dst = rmat_edges(LM_SCALE, 8, seed=0)
    w = degree_bias(src, dst, V, bias_bits=LM_BITS)
    bcfg = BingoConfig(num_vertices=V, capacity=LM_CAPACITY,
                       bias_bits=LM_BITS)
    state = from_edges(bcfg, src, dst, w, device="cuda")
    update = make_updater(bcfg)
    cfg = get_config(LM_ARCH)
    need(cfg.num_layers == 24 and cfg.vocab_size > V, f"{LM_ARCH} config")
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in lm_leaves(params))
    eng = DecodeEngine(cfg, params, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                       device="cuda")
    rng = np.random.default_rng(23)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    plan_round.launches = 0
    tick_ms, walk_err, upd_err, done = [], 0.0, 0.0, []
    prompts = []
    for wave in range(LM_WAVES):
        seeds = torch.from_numpy(rng.integers(0, V, LM_REQUESTS).astype(
            np.int32)).to("cuda")
        seed = int(rng.integers(0, 2**31 - 1))
        paths = walks.deepwalk(state, bcfg, seeds, seed, length=LM_WALK_LEN)
        want = walk_fused_ref(state.itable.prob, state.itable.alias,
                              state.bias, state.nbr, state.deg, None, seeds,
                              seed=seed, length=LM_WALK_LEN,
                              base_log2=bcfg.base_log2)
        walk_err = max(walk_err, path_diff(paths, want, f"wave {wave} walk"))
        rows = paths.cpu().numpy()
        ctx = [[int(t) for t in row if t >= 0][:LM_PROMPT] for row in rows]
        # every consecutive pair of a prompt is an edge of this wave's state
        pairs = np.array([(a, b) for c in ctx for a, b in zip(c, c[1:])],
                         np.int64).reshape(-1, 2)
        a = torch.from_numpy(pairs[:, 0]).to("cuda")
        b = torch.from_numpy(pairs[:, 1]).to("cuda")
        col = torch.arange(bcfg.capacity, device="cuda")[None, :]
        hit = (state.nbr[a] == b[:, None].to(torch.int32)) & \
            (col < state.deg[a][:, None])
        need(bool(hit.any(1).all()), f"wave {wave}: a prompt pair is no edge")
        prompts.append([len(c) for c in ctx])
        for i, c in enumerate(ctx):
            eng.submit(ServeRequest(rid=wave * 100 + i, prompt=c,
                                    max_new_tokens=LM_NEW))
        torch.cuda.synchronize()
        while eng.pending or any(r is not None for r in eng.slot_req):
            t0 = time.perf_counter()
            done += eng.step()              # ends in the tick's host read
            tick_ms.append((time.perf_counter() - t0) * 1e3)
        if wave == LM_WAVES - 1:
            break
        # one batched round of random inserts between the waves
        lanes = (torch.ones(LM_UPDATES, dtype=torch.bool, device="cuda"),
                 *(torch.from_numpy(x.astype(np.int32)).to("cuda") for x in (
                     rng.integers(0, V, LM_UPDATES),
                     rng.integers(0, V, LM_UPDATES),
                     rng.integers(1, 1 << LM_BITS, LM_UPDATES))))
        pre = clone_state(state)
        state, stats = update(state, *lanes)
        plain, pstats = batched_update(pre, bcfg, *lanes)
        upd_err = state_diff(plain, state, "phase 3i round vs batched_update")
        need(int(stats.ins_applied) == int(pstats.ins_applied) > 0,
             "phase 3i round: inserts applied")
        del pre, plain
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    out["launches"] = counts
    served = {k: counts[k] for k in ("walk_fused", "update_fused")}
    need(counts["walk_fused"] == LM_WAVES
         and counts["update_fused"] == LM_WAVES - 1
         and plan_round.launches == LM_WAVES - 1
         and sum(counts.values()) == 2 * LM_WAVES - 1,
         f"phase 3i launches {counts}, plan_round {plan_round.launches}")
    need(len(done) == LM_WAVES * LM_REQUESTS
         and all(r.done and len(r.output) == LM_NEW
                 and all(0 <= t < cfg.vocab_size for t in r.output)
                 for r in done), "phase 3i: requests' outputs")
    tokens = sum(len(r.output) for r in done)
    fed = sum(len(r.prompt) for r in done) + tokens
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    serve_s, ticks = sum(tick_ms) / 1e3, len(tick_ms)
    out.update(params=n_params, init_s=init_s, ticks=ticks,
               serve_s=serve_s, ms_per_tick=serve_s / ticks * 1e3,
               tick_ms_median=statistics.median(tick_ms),
               first_tick_ms=tick_ms[0],
               tokens=tokens, tokens_per_s=tokens / serve_s,
               fed_tokens_per_s=fed / serve_s, prompt_lens=prompts,
               walk_err=walk_err, update_err=upd_err, peak_gib=peak)
    print(f"{card}: {LM_ARCH} ({n_params / 1e6:.1f} M params, "
          f"{cfg.num_layers} layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}) behind deepwalk retrieval on "
          f"2^{LM_SCALE} vertices: {len(done)} requests in {LM_WAVES} waves "
          f"(prompt lengths {prompts}), {ticks} ticks of {LM_SLOTS} slots, "
          f"{out['ms_per_tick']:.2f} ms a tick (median "
          f"{out['tick_ms_median']:.2f}, the first {tick_ms[0]:.1f}), "
          f"{out['tokens_per_s']:.1f} "
          f"new tokens/s ({out['fed_tokens_per_s']:.1f} tokens/s fed "
          f"through the model), peak {peak:.2f} GiB above the phase's start; "
          f"launches {counts}; walks and the round equal their plain "
          f"versions", flush=True)

    # ---- 2. decode against forward on the card
    ops.reset_launch_counts()
    g = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (2, LM_CHECK_LEN), generator=g,
                           device="cuda")
    out["qwen2"] = lm_bf16_check(f"{LM_ARCH} FULL", params, cfg, tokens)
    del eng, params, state
    torch.cuda.empty_cache()
    lm_smoke_checks(out)
    mcfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=1)
    mparams = init_model(mcfg, torch.Generator(device="cuda").manual_seed(1))
    mtok = torch.randint(0, mcfg.vocab_size, (2, LM_CHECK_LEN), generator=g,
                         device="cuda")
    out["mixtral_params"] = sum(t.numel() for _, t in lm_leaves(mparams))
    out["mixtral"] = lm_bf16_check("mixtral-8x7b widths, 1 layer", mparams,
                                   mcfg, mtok)
    m32 = dataclasses.replace(mcfg, dtype="float32")
    ragged = forward(mparams, m32, {"inputs": mtok})[0]
    dense = forward(mparams, dataclasses.replace(m32, moe_dispatch="dense"),
                    {"inputs": mtok})[0]
    e = float((ragged - dense).abs().max())
    out["mixtral"]["ragged_dense"] = e
    print(f"mixtral-8x7b widths ({out['mixtral_params'] / 1e9:.2f} B params "
          f"at 1 layer), f32: ragged vs dense MoE {e:.3e} (limit "
          f"{LM_F32_TOL * float(dense.abs().max()):.3e})", flush=True)
    need(e <= LM_F32_TOL * float(dense.abs().max()),
         "mixtral: ragged vs dense MoE")
    del mparams, ragged, dense
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    need(sum(counts.values()) == 0, f"the model path launched {counts}")
    torch.cuda.empty_cache()
    out["peak_gib_all"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"{card}: phase 3i {out['phase_s']:.1f} s, peak "
          f"{out['peak_gib_all']:.2f} GiB above its start", flush=True)
    return served


def lm_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from lm_leaves(v, f"{path}/{k}")
    else:
        yield path, tree


# --------------------------------------------------------------- phase 3e
# phase 3j: training (launch/train.py's loop) at qwen2-0.5b's full width
TRAIN_SCALE, TRAIN_CAPACITY, TRAIN_BITS = 17, 256, 10
TRAIN_WALKERS, TRAIN_SEQ, TRAIN_BATCH = 512, 512, 8
TRAIN_STEPS, TRAIN_UPDATE_EVERY = 40, 10
TRAIN_UPDATE_BATCH, TRAIN_UPDATE_ROUNDS = 256, 10
# the mean of the last 5 losses is at least this far below the first
# (nat): under half the 4.83 nat the first card runs measured (PERF.md);
# the loss starts near ln(2^17 + 1) = 11.78
TRAIN_LOSS_DROP = 2.0
TRAIN_EQ_BATCH = 4                  # the equivalences' rows of 512 tokens
# remat against the plain step: every gradient within this fraction of
# its leaf's largest value; microbatches against one batch: within this
# fraction of the largest gradient of the tree
TRAIN_GRAD_TOL = 1e-5
# the example driver, as examples/train_walk_lm.py calls it
TRAIN_EXAMPLE = ["--scale", "10", "--d-model", "128", "--layers", "4",
                 "--seq-len", "64", "--batch", "8"]


def train_leaves(a, b):
    """(name, leaf of ``a``, the same leaf of ``b``) over a params tree or
    ``{"params", "opt"}``, named as a checkpoint names them."""
    from repro_torch.train.checkpoint import _leaves
    la, lb = _leaves(a), _leaves(b)
    need(la.keys() == lb.keys(), "two trees with different leaves")
    return [(k, x, lb[k]) for k, x in la.items()]


def grad_excess(got, want, tol):
    """(max over leaves of max|got - want| / (tol * max|want|), that leaf's
    name); <= 1 passes (a leaf of zeros must be zeros)."""
    worst, name = 0.0, ""
    for k, a, b in train_leaves(got, want):
        d = float((a.float() - b.float().to(a.device)).abs().max())
        scale = tol * float(b.abs().max())
        e = d / scale if scale else (0.0 if d == 0 else float("inf"))
        if e > worst:
            worst, name = e, k
    return worst, name


def tree_excess(got, want, tol):
    """max|got - want| over every leaf / (tol * max|want| over every leaf):
    a difference against the gradients' scale; <= 1 passes."""
    pairs = train_leaves(got, want)
    d = max(float((a.float() - b.float().to(a.device)).abs().max())
            for _, a, b in pairs)
    return d / (tol * max(float(b.abs().max()) for _, _, b in pairs))


def tree_bits_equal(a, b):
    import torch
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for _, x, y in train_leaves(a, b))


def checked_pipeline(*args, **kw):
    """A ``WalkCorpusPipeline`` that times each round's walk and packing
    (a sync on either side), holds the first round's paths against
    ``walk_fused_ref``, and checks that every consecutive pair of vertex
    tokens it packs is an edge of the state the round was sampled from."""
    import torch
    from repro_torch.data import WalkCorpusPipeline
    from repro_torch.kernels.walk_fused import walk_fused_ref

    class Checked(WalkCorpusPipeline):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.walk_ms, self.pack_ms, self.pairs = [], [], 0
            self.walk_err = None

        def walk(self, starts, seed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            paths = super().walk(starts, seed)
            torch.cuda.synchronize()
            self.walk_ms.append((time.perf_counter() - t0) * 1e3)
            if self.walk_err is None:
                st = self.state
                want = walk_fused_ref(
                    st.itable.prob, st.itable.alias, st.bias, st.nbr, st.deg,
                    None, starts, seed=seed, length=self.params.length,
                    base_log2=self.cfg.base_log2)
                self.walk_err = path_diff(paths, want, "phase 3j round 1")
            return paths

        def produce(self, paths):
            t0 = time.perf_counter()
            packed = super().produce(paths)
            self.pack_ms.append((time.perf_counter() - t0) * 1e3)
            need(bool((packed >= 0).all() and (packed <= self.sep).all()),
                 "phase 3j: a token outside the vocabulary")
            a, b = packed[:, :-1].ravel(), packed[:, 1:].ravel()
            keep = (a != self.sep) & (b != self.sep)
            st = self.state
            a = torch.from_numpy(a[keep].astype(np.int64)).cuda()
            b = torch.from_numpy(b[keep]).cuda()
            col = torch.arange(self.cfg.capacity, device="cuda")[None]
            hit = (st.nbr[a] == b[:, None]) & (col < st.deg[a][:, None])
            need(bool(hit.any(1).all()),
                 "phase 3j: a packed pair is no edge of its state")
            self.pairs += int(keep.sum())
            return packed

    return Checked(*args, **kw)


def train_smoke_arch(arch, seed=0):
    """``arch``'s SMOKE config in float32: ``loss_fn`` and every gradient
    on the card against the CPU on the same params (``lm_cpu_limit``'s
    tolerances, per leaf); returns the errors."""
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_model
    from repro_torch.train.train_step import value_and_grad
    cfg = smoke_config(arch)
    cpu = init_model(cfg, torch.Generator().manual_seed(300 + seed))
    dev = lm_tree(cpu, lambda t: t.to("cuda"))
    g = torch.Generator().manual_seed(400 + seed)
    toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=g)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.frontend != "none":
        batch["embeddings"] = torch.randn((2, 16, cfg.d_model), generator=g)
    lc, _, gc_ = value_and_grad(cpu, cfg, batch, remat="none")
    ld, _, gd = value_and_grad(
        dev, cfg, {k: v.cuda() for k, v in batch.items()}, remat="none")
    tol = LM_CPU_TOL.get(arch, LM_F32_TOL)
    e = {"loss": abs(float(ld) - float(lc))}
    e["grads"], e["leaf"] = grad_excess(gd, gc_, tol)
    need(e["loss"] <= tol * abs(float(lc)),
         f"{arch}: loss card != cpu ({e['loss']:.3e})")
    need(e["grads"] <= 1.0,
         f"{arch}: grads card != cpu ({e['grads']:.3f} of the limit "
         f"at {e['leaf']})")
    return e


def bf16_checkpoint_check(ckpt_dir):
    """Two steps of the SMOKE LM with bfloat16 moments on the card, then a
    checkpoint of ``{"params", "opt"}`` into ``ckpt_dir``, restored bit
    for bit."""
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_model
    from repro_torch.train.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.train.optim import OptConfig, adamw_init
    from repro_torch.train.train_step import make_train_step
    cfg = smoke_config(LM_ARCH)
    oc = OptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                   moment_dtype="bfloat16")
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(7))
    opt = adamw_init(params, oc)
    step = make_train_step(cfg, oc, remat="dots")
    g = torch.Generator(device="cuda").manual_seed(8)
    for _ in range(2):
        toks = torch.randint(0, cfg.vocab_size, (4, 17), generator=g,
                             device="cuda")
        params, opt, _, m = step(params, opt, None, {
            "inputs": toks[:, :-1], "targets": toks[:, 1:]})
    need(opt.mu["embed"].dtype == torch.bfloat16 and opt.mu["embed"].is_cuda
         and int(opt.step) == 2 and bool(torch.isfinite(m["loss"])),
         "phase 3j: bf16 moments")
    save_checkpoint(ckpt_dir, 2, {"params": params, "opt": opt})
    like = {"params": lm_tree(params, torch.zeros_like),
            "opt": adamw_init(params, oc)}
    back = restore_checkpoint(ckpt_dir, 2, like)
    need(tree_bits_equal(back, {"params": params, "opt": opt}),
         "phase 3j: bf16-moment checkpoint round trip")


def train_smoke_checks(out):
    """Every registry arch's SMOKE config on the card against the CPU
    (``train_smoke_arch``), then ``bf16_checkpoint_check``."""
    from repro_torch.configs import ARCHS
    res = {arch: train_smoke_arch(arch, i) for i, arch in enumerate(ARCHS)}
    print("SMOKE training on the card vs the CPU (f32): " + "; ".join(
        f"{a} loss {e['loss']:.1e}, grads {e['grads']:.3f} of the limit "
        f"({e['leaf']})" for a, e in res.items()), flush=True)
    out["smoke"] = res
    with tempfile.TemporaryDirectory() as d:
        bf16_checkpoint_check(d)
    out["bf16_checkpoint"] = "bit for bit"


def train_driver_check(out, ckpt_dir=None):
    """``launch.train.main`` on the card (its default device) with the
    example's arguments, 30 steps, checkpoints every 10; restored bit for
    bit; then 40 steps, which must resume from step 30.  The update rounds
    land at steps 10, 20 and 30 (one ``update_fused`` launch each) and the
    walks launch ``walk_fused``.  ``ckpt_dir`` defaults to a temporary
    directory."""
    import contextlib
    import io
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.train.checkpoint import restore_checkpoint
    if ckpt_dir is None:
        with tempfile.TemporaryDirectory() as d:
            return train_driver_check(out, d)
    ops.reset_launch_counts()
    argv = TRAIN_EXAMPLE + ["--ckpt-dir", ckpt_dir, "--ckpt-every", "10"]
    t0 = time.perf_counter()
    first = launch_train.main(argv + ["--steps", "30"])
    first_s = time.perf_counter() - t0
    need(next(iter(first["params"].values())).is_cuda,
         "phase 3j: the driver's params are not on the card")
    tree = {"params": first["params"], "opt": first["opt"]}
    back = restore_checkpoint(ckpt_dir, 30, tree)
    need(tree_bits_equal(back, tree), "phase 3j: driver checkpoint")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        second = launch_train.main(argv + ["--steps", "40"])
    print(buf.getvalue(), end="", flush=True)
    need("[train] restoring from step 30" in buf.getvalue()
         and second["start"] == 30 and len(second["losses"]) == 10
         and int(second["opt"].step) == 40,
         "phase 3j: the driver did not resume from step 30")
    losses = [float(x) for x in first["losses"] + second["losses"]]
    need(all(math.isfinite(x) for x in losses), "phase 3j: driver losses")
    counts = ops.launch_counts()
    need(counts["update_fused"] == 3 and counts["walk_fused"] >= 2,
         f"phase 3j: the driver's launches {counts}")
    out["driver"] = {"first_s": first_s, "loss_first": losses[0],
                     "loss_last": losses[-1], "launches": counts}


def train_phase(report, card):
    """Phase 3j: training at qwen2-0.5b's full width on a live walk corpus
    (module docstring).  Returns the training loop's launches by kernel."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.dyngraph import BingoConfig, from_edges
    from repro_torch.core.updates import batched_update, make_updater
    from repro_torch.distributed.compress import init_error_feedback
    from repro_torch.graph.rmat import degree_bias, rmat_edges
    from repro_torch.graph.streams import make_update_stream
    from repro_torch.kernels import ops
    from repro_torch.kernels.update_fused import plan_round
    from repro_torch.models import init_model, loss_fn
    from repro_torch.train.optim import OptConfig, adamw_init
    from repro_torch.train.train_step import make_train_step, value_and_grad
    out = report["train"] = {}
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()

    # ---- 1. launch/train.py's loop at full width
    V = 1 << TRAIN_SCALE
    src, dst = rmat_edges(TRAIN_SCALE, 8, seed=0)
    w = degree_bias(src, dst, V, bias_bits=TRAIN_BITS)
    bcfg = BingoConfig(num_vertices=V, capacity=TRAIN_CAPACITY,
                       bias_bits=TRAIN_BITS)
    state = from_edges(bcfg, src, dst, w, device="cuda")
    stream = make_update_stream(src, dst, w, batch_size=TRAIN_UPDATE_BATCH,
                                rounds=TRAIN_UPDATE_ROUNDS, mode="mixed",
                                seed=1)
    pipe = checked_pipeline(state, bcfg, walkers_per_round=TRAIN_WALKERS,
                            seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH)
    update = make_updater(bcfg)
    cfg = dataclasses.replace(get_config(LM_ARCH), vocab_size=pipe.vocab,
                              frontend="none")
    need(cfg.num_layers == 24 and cfg.d_model == 896, f"{LM_ARCH} config")
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for _, t in lm_leaves(params))
    oc = OptConfig(warmup_steps=10, total_steps=TRAIN_STEPS)
    opt = adamw_init(params, oc)
    step_fn = make_train_step(cfg, oc, remat="none")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_phase
    ops.reset_launch_counts()
    plan_round.launches = 0
    losses, step_ms, round_i, upd_err = [], [], 0, 0.0
    for step in range(TRAIN_STEPS):
        if step and step % TRAIN_UPDATE_EVERY == 0 and \
                round_i < TRAIN_UPDATE_ROUNDS:
            lanes = [torch.from_numpy(x[round_i]).to("cuda") for x in (
                stream.is_insert, stream.u, stream.v, stream.w)]
            pre = clone_state(state)
            state, stats = update(state, *lanes)
            plain, pstats = batched_update(pre, bcfg, *lanes)
            upd_err = max(upd_err, state_diff(
                plain, state, f"phase 3j round {round_i + 1}"))
            need(stats_list(stats) == stats_list(pstats),
                 f"phase 3j round {round_i + 1}: stats")
            del pre, plain
            pipe.update_graph(state)
            round_i += 1
        batch = next(pipe)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, _, m = step_fn(params, opt, None, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"])
    counts = ops.launch_counts()
    rounds = pipe.rounds
    out["launches"] = counts
    served = {k: counts[k] for k in ("walk_fused", "update_fused")}
    need(counts["walk_fused"] == rounds
         and counts["update_fused"] == round_i == 3
         and plan_round.launches == round_i
         and sum(counts.values()) == rounds + round_i,
         f"phase 3j launches {counts}, plan_round {plan_round.launches}, "
         f"{rounds} rounds")
    losses = [float(x) for x in losses]
    need(all(math.isfinite(x) for x in losses), "phase 3j: a loss is not "
         "finite")
    drop = losses[0] - statistics.mean(losses[-5:])
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    # the host syncs of one train step (outside the loop: one more batch)
    batch = next(pipe)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            params, opt, _, m = step_fn(params, opt, None, batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("called a synchronizing" in str(x.message) for x in caught)
    # the f32 head product and its two gradient products, timed alone
    tokens = TRAIN_BATCH * TRAIN_SEQ
    x = torch.randn((tokens, cfg.d_model), device="cuda")
    emb = params["embed"]
    gl = torch.randn((tokens, cfg.vocab_size), device="cuda")
    head_ms, _ = cuda_ms(lambda: (x @ emb.T, gl @ emb, gl.T @ x))
    head_bound = 3 * 2 * tokens * cfg.d_model * cfg.vocab_size / hw.OPS_PER_S
    del x, gl
    med = statistics.median(step_ms)
    pipe_ms = (sum(pipe.walk_ms) + sum(pipe.pack_ms)) / TRAIN_STEPS
    flops = 6 * n_params * tokens
    out.update(params=n_params, vocab=cfg.vocab_size, setup_s=setup_s,
               losses=losses, loss_drop=drop, step_ms=step_ms,
               step_ms_median=med, step_ms_mean=statistics.mean(step_ms),
               step_ms_first=step_ms[0], rounds=rounds,
               walk_ms=pipe.walk_ms, pack_ms=pipe.pack_ms,
               pipeline_ms_per_step=pipe_ms, pairs_checked=pipe.pairs,
               tokens_per_s=tokens / med * 1e3,
               model_tflops=flops / med / 1e9, peak_gib=peak,
               host_syncs_per_step=syncs, head_ms=head_ms,
               head_bound_ms=head_bound * 1e3, walk_err=pipe.walk_err,
               update_err=upd_err)
    print(f"{card}: training {LM_ARCH} ({n_params / 1e6:.1f} M params, "
          f"vocab {cfg.vocab_size} = 2^{TRAIN_SCALE} vertices + sep, "
          f"{cfg.dtype} activations, lr {oc.lr}) on deepwalk batches "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}: {TRAIN_STEPS} steps, ms a step "
          f"median {med:.2f} (mean {out['step_ms_mean']:.2f}, first "
          f"{step_ms[0]:.1f}); pipeline {rounds} rounds, walk "
          f"{statistics.median(pipe.walk_ms):.2f} ms and pack "
          f"{statistics.median(pipe.pack_ms):.2f} ms a round (median), "
          f"{pipe_ms:.2f} ms a step; {out['tokens_per_s']:.0f} tokens/s, "
          f"model {out['model_tflops']:.1f} TFLOP/s (6 N tokens; bf16 "
          f"tensor-core peak {hw.PEAK_FLOPS_BF16 / 1e12:.0f}); peak "
          f"{peak:.2f} GiB above the phase's start; {syncs} host syncs in "
          f"one step; the f32 head product and its two gradient products "
          f"alone {head_ms:.2f} ms (bound {head_bound * 1e3:.2f} ms at "
          f"{hw.OPS_PER_S / 1e12:.0f} TFLOP/s); loss {losses[0]:.4f} -> last 5 mean "
          f"{statistics.mean(losses[-5:]):.4f} (drop {drop:.3f}, limit "
          f"{TRAIN_LOSS_DROP}); launches {counts}; the first round and the "
          f"{round_i} update rounds equal their plain versions; "
          f"{pipe.pairs} packed pairs are edges", flush=True)
    need(drop >= TRAIN_LOSS_DROP, f"phase 3j: loss fell {drop:.3f} nat, "
         f"less than {TRAIN_LOSS_DROP}")
    del opt, state, pipe

    # ---- 2. equivalences at full width, batch 4 x 512
    ops.reset_launch_counts()
    b4 = {k: v[:TRAIN_EQ_BATCH] for k, v in batch.items()}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with torch.no_grad():
        l32 = float(loss_fn(params, cfg32, b4)[0])
        l16 = float(loss_fn(params, cfg, b4)[0])
    eq = {"loss_f32": l32, "loss_bf16": l16, "bf16_limit":
          LM_BF16_STEP * abs(l32)}
    need(abs(l16 - l32) <= eq["bf16_limit"],
         f"phase 3j: bf16 loss {l16} vs f32 {l32}")
    ln, _, gn = value_and_grad(params, cfg, b4, remat="none")
    for remat in ("full", "dots"):
        lr_, _, gr = value_and_grad(params, cfg, b4, remat=remat)
        eq[f"{remat}_loss"] = abs(float(lr_) - float(ln))
        eq[f"{remat}_grads"], eq[f"{remat}_leaf"] = grad_excess(
            gr, gn, TRAIN_GRAD_TOL)
        need(eq[f"{remat}_loss"] == 0.0 and eq[f"{remat}_grads"] <= 1.0,
             f"phase 3j: remat {remat} != none ({eq[f'{remat}_loss']}, "
             f"{eq[f'{remat}_grads']:.3f} of the limit at "
             f"{eq[f'{remat}_leaf']})")
        del gr
    del gn
    _, _, g1 = value_and_grad(params, cfg32, b4, remat="none")
    _, _, g4 = value_and_grad(params, cfg32, b4, remat="none",
                              microbatches=TRAIN_EQ_BATCH)
    # against the gradients' scale (test_substrate.py's atol on O(1)
    # grads): splitting the batch reorders each weight's sum over its
    # 2,048 token terms, and a leaf whose terms cancel keeps that
    # rounding relative to the terms, not to its own largest value
    eq["micro_grads"] = tree_excess(g4, g1, TRAIN_GRAD_TOL)
    eq["micro_leaf_excess"], eq["micro_leaf"] = grad_excess(
        g4, g1, TRAIN_GRAD_TOL)
    need(eq["micro_grads"] <= 1.0, f"phase 3j: microbatches "
         f"{eq['micro_grads']:.3f} of the limit")
    del g1, g4
    ef = init_error_feedback(params)
    cstep = make_train_step(cfg, OptConfig(warmup_steps=10,
                                           total_steps=TRAIN_STEPS),
                            remat="dots", compress=True)
    params, _, ef, mc = cstep(params, adamw_init(params, oc), ef, b4)
    need(bool(torch.isfinite(mc["loss"])) and all(
        bool(torch.isfinite(t).all()) for _, t in lm_leaves(ef)),
        "phase 3j: compressed step")
    del ef, params
    torch.cuda.empty_cache()
    print(f"{card}: full width, batch {TRAIN_EQ_BATCH} x {TRAIN_SEQ}: loss "
          f"f32 {l32:.5f}, bf16 {l16:.5f} (|diff| {abs(l16 - l32):.2e}, "
          f"limit {eq['bf16_limit']:.2e}); remat full / dots vs none: loss "
          f"diff {eq['full_loss']:.1e} / {eq['dots_loss']:.1e}, grads "
          f"{eq['full_grads']:.3f} / {eq['dots_grads']:.3f} of the limit "
          f"({TRAIN_GRAD_TOL} of each leaf's largest value); f32 "
          f"microbatches {TRAIN_EQ_BATCH} vs 1: {eq['micro_grads']:.3f} of "
          f"{TRAIN_GRAD_TOL} of the gradients' largest value (per leaf "
          f"{eq['micro_leaf_excess']:.3f} of the remat limit, at "
          f"{eq['micro_leaf']}); a compressed step's loss {float(mc['loss']):.4f}, "
          f"error feedback finite", flush=True)
    out["equivalences"] = eq

    # ---- 3. SMOKE configs on the card against the CPU
    train_smoke_checks(out)
    counts = ops.launch_counts()
    need(sum(counts.values()) == 0, f"the training model path launched "
         f"{counts}")
    # ---- 4. the driver itself
    train_driver_check(out)
    out["peak_gib_all"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"{card}: phase 3j {out['phase_s']:.1f} s (set-up "
          f"{setup_s:.1f} s), peak {out['peak_gib_all']:.2f} GiB above its "
          f"start; the driver: 30 steps in {out['driver']['first_s']:.1f} s, "
          f"resumed at step 30, loss {out['driver']['loss_first']:.4f} -> "
          f"{out['driver']['loss_last']:.4f}, launches "
          f"{out['driver']['launches']}", flush=True)
    return served


# phase 3k: the kernels each one-rank cell must launch (its dry run's
# cells are ``repro_torch.launch.dryrun.RANK_CELLS``)
RANK_KERNELS = {"walk_step": ("walk_sample",), "walk_whole": ("walk_fused",),
                "update_step": ("update_fused",),
                "update_walk": ("update_fused", "walk_fused"),
                "walk_relay": ("walk_segment",),
                "serve_round": ("walk_segment", "update_fused")}
RANK_REPS = 3                      # timed runs a cell (median)
RANK_PEAK_UNDER = 0.10             # the fake peak may sit this far under
DMA_WALKERS_PER_SM = 2
DRYRUN_TIMEOUT_S = 300


def rank_graph(V, C, seed=0):
    """``(src, dst, w)``: a power-law graph on V vertices whose degrees
    (Pareto, tail exponent 2.2, capped at C) average MEAN_DEGREE (FULL's
    source, roofline.py);
    neighbours uniform, biases in [1, 2^16)."""
    rng = np.random.default_rng(seed)
    x = rng.pareto(1.2, V) + 1.0

    def mean_at(s):
        return np.minimum(np.floor(s * x), C).mean()
    lo, hi = 0.1, 100.0
    for _ in range(60):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if mean_at(mid) < MEAN_DEGREE else (lo, mid)
    deg = np.minimum(np.floor(lo * x), C).astype(np.int64)
    src = np.repeat(np.arange(V, dtype=np.int32), deg)
    dst = rng.integers(0, V, src.size, dtype=np.int32)
    w = rng.integers(1, 1 << 16, src.size, dtype=np.int32)
    return src, dst, w


def rank_args(cell, proto, state, src, dst, rng):
    """Real arguments of ``cell`` shaped as its fake ``proto``: ``state``
    for the state, start vertices uniform over its rows, an update batch
    of half inserts of new edges and half deletes of existing ones, every
    lane live."""
    import torch
    V, dev = state.nbr.shape[0], state.nbr.device
    out = []
    for name, p in zip(cell.meta["args"], proto):
        if name == "state":
            out.append(state)
        elif name == "seed":
            out.append(7)
        elif name in ("walkers", "starts"):
            out.append(torch.from_numpy(rng.integers(
                0, V, p.shape[0], dtype=np.int32)).to(dev))
        elif name == "is_insert":
            ins = np.zeros(p.shape[0], bool)
            ins[: p.shape[0] // 2] = True
            rng.shuffle(ins)
            pick = rng.integers(0, src.size, p.shape[0])
            uv = {"u": np.where(ins, rng.integers(0, V, ins.size), src[pick]),
                  "v": np.where(ins, rng.integers(0, V, ins.size), dst[pick]),
                  "w": rng.integers(1, 1 << 16, ins.size)}
            out.append(torch.from_numpy(ins).to(dev))
        elif name in ("u", "v", "w"):
            out.append(torch.from_numpy(uv[name].astype(np.int32)).to(dev))
        elif name == "lanes":
            out.append(torch.ones(p.shape[0], dtype=torch.bool, device=dev))
        else:
            raise SmokeFailure(f"{cell.shape_name}: no real argument for "
                               f"{name!r}")
    return tuple(out)


def storage_bytes(tree):
    """Bytes of the distinct storages among ``tree``'s tensors."""
    import torch
    from torch.utils._pytree import tree_flatten
    seen = {}
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            s = t.untyped_storage()
            seen[s.data_ptr()] = s.nbytes()
    return sum(seen.values())


def dryrun_start(*runs):
    """Start each of ``runs``, ``(out_dir, *args)``, as ``python -m
    repro_torch.launch.dryrun --all --out out_dir *args`` in a subprocess
    of its own (their fake worlds never meet this process's groups);
    ``dryrun_collect`` waits for them."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    try:
        for out_dir, *args in runs:
            Path(out_dir).mkdir(parents=True, exist_ok=True)
            log = open(Path(out_dir) / "dryrun.log", "w+")
            procs.append((out_dir, args, log, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                 "--out", str(out_dir), *args], stdout=log,
                stderr=subprocess.STDOUT, text=True, env=env,
                cwd=str(ROOT))))
    except BaseException:
        dryrun_stop(procs)
        raise
    return {"procs": procs, "deadline": time.monotonic() + DRYRUN_TIMEOUT_S}


def dryrun_stop(procs):
    for _, _, log, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def dryrun_collect(started):
    """The started runs' output printed, each run's JSONs returned by
    label (shape[tag]), in the order they were started; every run must
    exit 0 by its deadline."""
    try:
        out = []
        for out_dir, args, log, proc in started["procs"]:
            rc = proc.wait(timeout=max(1.0, started["deadline"]
                                       - time.monotonic()))
            log.seek(0)
            text = log.read()
            print(text, end="", flush=True)
            need(rc == 0, f"the dry run {args} exited {rc}: {text[-2000:]}")
            docs = {}
            for f in sorted(Path(out_dir).glob("*.json")):
                d = json.loads(f.read_text())
                tag = d["meta"].get("overrides", {}).get("tag")
                docs[d["shape"] + (f"[{tag}]" if tag else "")] = d
            out.append(docs)
        return out
    finally:
        dryrun_stop(started["procs"])


def dryrun_runs(*runs):
    """``dryrun_start`` then ``dryrun_collect`` of ``runs``."""
    return dryrun_collect(dryrun_start(*runs))


def dryrun_cli(out_dir, *args):
    """``dryrun_runs`` of the one run ``(out_dir, *args)``: its docs."""
    return dryrun_runs((out_dir, *args))[0]


def plain_backend():
    """The fused engine backend with each kernel's plain version in its
    place, on the same draws: a cell built on it computes what the
    kernels of the same cell must."""
    import torch
    from repro_torch.core.backend import FusedBackend, segment_args
    from repro_torch.kernels.update_fused import update_fused_ref
    from repro_torch.kernels.walk_fused import walk_fused_ref, walk_segment_ref
    from repro_torch.kernels.walk_sample import walk_sample_ref

    class Plain(FusedBackend):
        name = "plain"

        def sample_step(self, state, cfg, u, gen):
            rows = u.to(torch.int32).contiguous()
            extended = cfg.fp_bias or cfg.base_log2 > 1
            uu = torch.rand((rows.shape[0], 5 if extended else 3),
                            generator=gen, device=gen.device)
            return walk_sample_ref(
                state.itable.prob, state.itable.alias, state.bias, state.nbr,
                state.deg, uu, state.frac if cfg.fp_bias else None,
                base_log2=cfg.base_log2, rows=rows)

        def sample_walk(self, state, cfg, starts, seed, params, u=None):
            need(params.kind in ("deepwalk", "ppr", "simple"),
                 f"plain_backend: no whole walk for {params.kind}")
            stop = float(params.stop_prob) if params.kind == "ppr" else 0.0
            return walk_fused_ref(
                state.itable.prob, state.itable.alias, state.bias, state.nbr,
                state.deg, state.frac if cfg.fp_bias else None, starts, u,
                seed=seed, length=params.length, base_log2=cfg.base_log2,
                stop_prob=stop, uniform=params.kind == "simple")

        def sample_walk_segment(self, state, cfg, starts, t0, seed, params,
                                u=None, wid=None):
            args, kw = segment_args(state, cfg, starts, t0, seed, params, u,
                                    wid)
            return walk_segment_ref(*args, **kw)

        def apply_updates(self, state, cfg, is_insert, u, v, w, active=None):
            return update_fused_ref(state, cfg, is_insert, u, v, w, active)

    return Plain()


def same_outputs(got, want, what):
    """Fails unless a cell's kernel outputs ``got`` equal its plain
    outputs ``want`` leaf by leaf (states through ``state_diff``)."""
    import torch
    from repro_torch.core.dyngraph import BingoState
    if isinstance(got, BingoState):
        state_diff(got, want, what)
    elif isinstance(got, torch.Tensor):
        need(isinstance(want, torch.Tensor) and got.shape == want.shape
             and got.dtype == want.dtype,
             f"{what}: kernel {tuple(got.shape)} {got.dtype}, plain "
             f"{getattr(want, 'shape', want)}")
        need(torch.equal(got, want), f"{what}: kernel != plain "
             f"({int((got != want).sum())} of {got.numel()} entries differ)")
    elif isinstance(got, (tuple, list)):
        need(type(got) is type(want) and len(got) == len(want),
             f"{what}: kernel and plain outputs differ in structure")
        for i, (g, w) in enumerate(zip(got, want)):
            same_outputs(g, w, f"{what}[{i}]")
    else:
        need(got == want, f"{what}: kernel {got!r}, plain {want!r}")


def rank_cell_checks(out, docs, wcfg, card):
    """Each one-rank cell of the dry run's ``docs`` (``dryrun_cli`` with
    ``--mesh 1x1 --sizing rank``) run for real through ``build_walk_cell``
    on ``make_local_mesh()`` over the caller's one-rank NCCL world:
    argument bytes equal, the fake peak at most RANK_PEAK_UNDER under the
    real one, the cell's kernels (RANK_KERNELS) launched, and its outputs
    (paths, updated state, stats) equal to the same cell's on
    ``plain_backend()`` on the same inputs; real against predicted ms and
    the kernel byte models against the walks' real needs printed; then
    ``dma_latency``.  Returns the launches by kernel."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core.dyngraph import BingoConfig, from_edges
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import RANK_CELLS, fake_device
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.walk_cell import build_walk_cell
    V, C = wcfg.num_vertices, wcfg.capacity
    t0 = time.perf_counter()
    src, dst, w = rank_graph(V, C)
    states = {}
    for mult in sorted({(ov or {}).get("capacity_mult", 1)
                        for _, ov in RANK_CELLS}):
        cfg = BingoConfig(V, C * mult, bias_bits=wcfg.bias_bits)
        states[mult] = from_edges(cfg, src, dst, w, device="cuda")
    torch.cuda.synchronize()
    out["graph"] = {"vertices": V, "edges": int(src.size),
                    "mean_degree": src.size / V,
                    "max_degree": int(np.bincount(src, minlength=V).max()),
                    "build_s": time.perf_counter() - t0}
    print(f"phase 3k: one rank of FULL: {V} rows, C = {C}, {src.size} edges "
          f"(mean degree {src.size / V:.1f}, max {out['graph']['max_degree']}), "
          f"built in {out['graph']['build_s']:.1f} s", flush=True)
    launches = {}
    rng = np.random.default_rng(3)
    mesh = make_local_mesh()
    plain_bk = plain_backend()
    cells = out["cells"] = {}
    need(len(docs) == len(RANK_CELLS), f"the one-rank dry run wrote "
         f"{len(docs)} cells, want {len(RANK_CELLS)}")
    for shape, ov in RANK_CELLS:
        ov = ov or {}
        want = RANK_KERNELS[shape]
        label = shape + (f"[{ov['tag']}]" if "tag" in ov else "")
        doc = docs[label]
        cell = build_walk_cell(shape, mesh, ov, wcfg)
        with FakeTensorMode():
            proto = cell.args(fake_device())
        base = states[ov.get("capacity_mult", 1)]
        args = rank_args(cell, proto, base, src, dst, rng)
        donating = bool(cell.donate)

        def fresh():
            return (clone_state(base),) + args[1:] if donating else args
        call = fresh()
        real_args = storage_bytes(call)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        res = cell.fn(*call)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        real_peak = torch.cuda.max_memory_allocated() - before + real_args
        ms, res = cuda_ms(lambda a: cell.fn(*a), reps=RANK_REPS,
                          setup=fresh)
        for k, v in ops.launch_counts().items():    # the first run's too
            launches[k] = launches.get(k, 0) + v
        mem = doc["memory_analysis"]
        pred_ms = max(doc["t_compute"], doc["t_memory"]) * 1e3
        row = {"real_ms": ms, "pred_ms": pred_ms, "ratio": ms / pred_ms,
               "t_collective_ms": doc["t_collective"] * 1e3,
               "real_arg_bytes": real_args,
               "fake_arg_bytes": mem["argument_size_in_bytes"],
               "real_peak_bytes": real_peak,
               "fake_peak_bytes": mem["total_nonalias_bytes"],
               "launches": {k: counts[k] for k in want},
               "kernel_model": doc["meta"]["kernels"]}
        row["peak_fake_over_real"] = row["fake_peak_bytes"] / real_peak
        walked = kernel_need(shape, cell, call, res)
        if walked is not None:
            name, need_b = walked
            row["kernel_need_bytes"] = {name: need_b}
            row["model_over_need"] = \
                doc["meta"]["kernels"][name]["bytes"] / need_b
        cells[label] = row
        print(f"  {label}: real {ms:.3f} ms, predicted max(compute, "
              f"memory) {pred_ms:.3f} ms (ratio {ms / pred_ms:.2f}); "
              f"peak real {real_peak / 2**30:.3f} GiB, fake "
              f"{row['fake_peak_bytes'] / 2**30:.3f} GiB "
              f"({row['peak_fake_over_real']:.3f}); arguments "
              f"{real_args} B real, {row['fake_arg_bytes']} B fake; "
              f"launches {row['launches']}"
              + ("" if walked is None else
                 f"; {walked[0]} model {doc['meta']['kernels'][walked[0]]['bytes'] / 1e9:.3f} "
                 f"GB against {walked[1] / 1e9:.3f} GB needed "
                 f"({row['model_over_need']:.1f}x)"), flush=True)
        need(real_args == row["fake_arg_bytes"],
             f"{label}: argument bytes {real_args} real, "
             f"{row['fake_arg_bytes']} fake")
        need(row["fake_peak_bytes"] >= (1 - RANK_PEAK_UNDER) * real_peak,
             f"{label}: the fake peak {row['fake_peak_bytes']} B is more "
             f"than {RANK_PEAK_UNDER:.0%} under the real {real_peak} B")
        need(all(counts[k] > 0 for k in want),
             f"{label}: launches {counts}, want {want}")
        t_plain = time.perf_counter()
        plain = build_walk_cell(shape, mesh, ov, wcfg, backend=plain_bk)
        counted = ops.launch_counts()
        same_outputs(res, plain.fn(*fresh()), f"phase 3k {label}")
        torch.cuda.synchronize()
        need(ops.launch_counts() == counted, f"{label}: the plain cell "
             f"launched a kernel")
        row["plain_s"] = time.perf_counter() - t_plain
        print(f"  {label}: outputs equal the plain cell's at C = "
              f"{base.nbr.shape[1]} ({row['plain_s']:.1f} s)", flush=True)
        del call, res
    out["dma"] = dma_latency(states[1], wcfg, card)
    return launches


def kernel_need(shape, cell, call, res):
    """``(kernel, bytes)`` the cell's walk kernel needed on this run's data
    (``walk_work``/``sample_work``), or None for an update-only cell."""
    st = call[0]
    if shape in ("walk_whole", "update_walk"):
        paths = res if shape == "walk_whole" else res[1]
        return "walk_fused", walk_work(paths, st.deg, False)["bytes"]
    if shape in ("walk_relay", "serve_round"):
        paths = res[0] if shape == "walk_relay" else res[1]
        return "walk_segment", walk_work(paths, st.deg, False)["bytes"]
    if shape == "walk_step":
        import torch
        rows = call[1].clamp(0, st.nbr.shape[0] - 1)
        nxt = torch.zeros_like(rows)          # every row drawn, one hop each
        return "walk_sample", sample_work(rows, nxt, st.deg, 3, False)["bytes"]
    return None


def dma_latency(state, wcfg, card):
    """One dependent row gather's latency: B1's whole walk of
    DMA_WALKERS_PER_SM walkers an SM over L steps on the one-rank state,
    median device ms / L, beside ``hw.DMA_LATENCY``."""
    import torch
    from repro_torch.kernels import ops
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    B, L = DMA_WALKERS_PER_SM * sms, wcfg.walk_length
    starts = torch.from_numpy(np.random.default_rng(5).integers(
        0, state.nbr.shape[0], B, dtype=np.int32)).cuda()
    st = state
    ms, _ = cuda_ms(lambda: ops.walk_fused(
        st.itable.prob, st.itable.alias, st.bias, st.nbr, st.deg, None,
        starts, 11, length=L), reps=5)
    lat = ms / L * 1e-3
    print(f"{card}: DMA_LATENCY measured {lat * 1e6:.3f} us ({B} walkers, "
          f"L = {L}, {ms:.3f} ms); launch/hw.py holds "
          f"{hw.DMA_LATENCY * 1e6:.3f} us", flush=True)
    return {"walkers": B, "length": L, "ms": ms, "seconds": lat,
            "hw_seconds": hw.DMA_LATENCY}


def dryrun_phase(report, card, lm=None):
    """Phase 3k: the dry run of the walk cells on a fake 256-rank world
    and on a fake world of one at one rank's share (two subprocesses at
    once, ``dryrun_runs``), then that share for real on the card over a
    one-rank NCCL group (``rank_cell_checks``).  ``lm``, phase 3l's dry
    runs (``lm_dryrun_start``), is collected before the real part, so
    that no dry run shares the host with its timing.  Returns the real
    runs' launches by kernel."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.walk_cell import one_rank_share
    out = report["dryrun"] = {}
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="dryrun_"))
    t0 = time.perf_counter()
    docs, fake = dryrun_runs((tmp / "pod16x16", "--arch-filter", "bingo-walk"),
                             (tmp / "rank", "--arch-filter", "bingo-walk",
                              "--mesh", "1x1", "--sizing", "rank"))
    need(len(docs) == 8, f"the dry run wrote {len(docs)} cells, want 8")
    out["pod16x16"] = {k: {"gib": d["memory_analysis"]["total_nonalias_bytes"]
                           / 2**30, "fit": d["hbm_fit"],
                           "t_ms": {t: d[t] * 1e3 for t in (
                               "t_compute", "t_memory", "t_collective")}}
                       for k, d in docs.items()}
    if lm is not None:
        lm_dryrun_collect(lm)
    out["dryruns_s"] = time.perf_counter() - t0
    total = torch.cuda.get_device_properties(0).total_memory
    out["total_memory"] = total
    print(f"{card}: total_memory {total} B ({total / 2**30:.2f} GiB); "
          f"launch/hw.py's HBM_BYTES {hw.HBM_BYTES} B", flush=True)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp / "store"), 1), rank=0, world_size=1)
    try:
        launches = rank_cell_checks(out, fake, one_rank_share(), card)
    finally:
        dist.destroy_process_group()
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"{card}: phase 3k {out['phase_s']:.1f} s (the dry runs "
          f"{out['dryruns_s']:.1f} s" + (", phase 3l's among them)"
                                         if lm is not None else ")"),
          flush=True)
    return launches


# phase 3l: the dry run's LM cells, LM_ARCH's three
LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
LM_SEED = 9
LM_STEP = 10            # the optimizer's step count going in (lm_inputs)


def local_tree(tree):
    """``tree`` with each DTensor replaced by its local shard."""
    from torch.utils._pytree import tree_map
    return tree_map(lambda t: t.to_local() if type(t).__name__ == "DTensor"
                    else t, tree)


def clone_tree(tree):
    """A copy of ``tree`` (dicts, tuples, OptStates, tensors, None)."""
    import torch
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*[clone_tree(v) for v in tree]) \
            if hasattr(tree, "_fields") else tuple(clone_tree(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def lm_inputs(name, shape, cfg, batch=None, device="cuda", pos=None):
    """The plain global inputs of the LM cell ``name`` at ``shape``, the
    same on every rank: params from a seeded generator, moments at step
    LM_STEP drawn beside them (at step 0 AdamW moves each weight by about
    lr·sign(g), so a gradient of rounding noise would move it either
    way), token ids (``batch`` for a train cell if given), a zero cache
    written at ``pos`` (default ``seq_len // 2``)."""
    import torch
    from torch.utils._pytree import tree_map
    from repro_torch.models.model import init_decode_cache, init_model
    from repro_torch.train.optim import OptState
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    params = init_model(cfg, gen)
    B, S = shape.global_batch, shape.seq_len

    def ids(*dims):
        return torch.randint(0, cfg.vocab_size, dims, generator=gen,
                             device=device, dtype=torch.int32)
    if name == "decode_32k":
        return (params, ids(B), torch.full((B,), S // 2 if pos is None
                                           else pos, dtype=torch.int32,
                                           device=device),
                init_decode_cache(cfg, B, S, device=device))
    if name == "prefill_32k":
        return (params, {"inputs": ids(B, S)})
    mu = tree_map(lambda p: 1e-3 * torch.randn(
        p.shape, generator=gen, device=device), params)
    nu = tree_map(lambda p: 1e-6 + 9e-6 * torch.rand(
        p.shape, generator=gen, device=device), params)
    opt = OptState(torch.tensor(LM_STEP, dtype=torch.int32, device=device),
                   mu, nu)
    return (params, opt, None,
            batch or {"inputs": ids(B, S), "targets": ids(B, S)})


# phase 3l: a leaf of the train step whose gradient is zero in exact
# arithmetic (a bias added to every key shifts all of a query's logits
# alike, which the softmax ignores), so its update, moments included, is
# rounding noise: held within this of the plain run's, not bit for bit
# (on the card 4 of its 3,072 entries differed by up to 1.04e-9 in the
# params; every other leaf of every cell was equal bit for bit)
LM_NOISE_LEAVES = (".attn.bk",)
LM_NOISE_ABS = 1e-6


def same_tree(got, want, what, noise=None):
    """Fails unless ``got`` equals ``want`` leaf by leaf, bit for bit;
    leaves whose path ends with one of ``LM_NOISE_LEAVES`` within
    LM_NOISE_ABS, their largest difference appended to ``noise``."""
    import torch
    if isinstance(want, dict):
        need(isinstance(got, dict) and sorted(got) == sorted(want),
             f"{what}: keys differ")
        for k in want:
            same_tree(got[k], want[k], f"{what}.{k}", noise)
    elif isinstance(want, (tuple, list)):
        need(len(got) == len(want), f"{what}: lengths differ")
        for i, (g, w) in enumerate(zip(got, want)):
            same_tree(g, w, f"{what}[{i}]", noise)
    elif isinstance(want, torch.Tensor):
        need(got.shape == want.shape and got.dtype == want.dtype,
             f"{what}: {tuple(got.shape)} {got.dtype} against "
             f"{tuple(want.shape)} {want.dtype}")
        if noise is not None and what.endswith(LM_NOISE_LEAVES):
            d = float((got.double() - want.double()).abs().max())
            noise.append((what, d))
            need(d <= LM_NOISE_ABS, f"{what}: {d:.3e} from the plain run")
            return
        need(torch.equal(got, want), f"{what}: "
             f"{int((got != want).sum())} of {got.numel()} entries differ")
    else:
        need(got == want, f"{what}: {got!r} against {want!r}")


def lm_rank_cell_checks(out, docs, card):
    """qwen2-0.5b's three cells at one rank's share (``rank_shape``: the
    global batch cut to 1 of 256) at FULL width, built through
    ``build_cell`` on ``make_local_mesh()`` over the caller's one-rank
    NCCL world, for real: argument bytes equal the dry run's
    (``docs``, ``--mesh 1x1 --sizing rank``), the fake peak at most
    RANK_PEAK_UNDER under the real one, the outputs (the train step's
    loss and updated params and moments, prefill's logits, decode's
    logits and cache) equal to the same function's on plain tensors bit
    for bit (``LM_NOISE_LEAVES`` within LM_NOISE_ABS), no kernel
    launched; real ms (median of RANK_REPS) printed
    beside the predicted max(compute, memory)."""
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.specs import build_cell, place, rank_shape
    mesh = make_local_mesh()
    cfg = get_config(LM_ARCH)
    cells = out["lm_cells"] = {}
    need(sorted(docs) == sorted(LM_SHAPES), f"the one-rank LM dry run wrote "
         f"{sorted(docs)}, want {sorted(LM_SHAPES)}")
    for name in LM_SHAPES:
        doc = docs[name]
        shape = rank_shape(SHAPES[name])
        cell = build_cell(LM_ARCH, name, mesh, shape=shape)
        vals = lm_inputs(name, shape, cfg)
        plain = clone_tree(vals)
        args = place(vals, cell.specs, mesh)
        real_args = storage_bytes(local_tree(args))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        counted = ops.launch_counts()
        res = cell.fn(*args)
        torch.cuda.synchronize()
        real_peak = torch.cuda.max_memory_allocated() - before + real_args
        res = local_tree(res)
        want = cell.fn(*plain)
        torch.cuda.synchronize()
        noise = []
        same_tree(res, want, f"phase 3l {name}: the DTensor cell against "
                  f"the plain one", noise)
        del want, plain
        ms, _ = cuda_ms(lambda: cell.fn(*args), reps=RANK_REPS)
        need(ops.launch_counts() == counted, f"phase 3l {name}: a kernel "
             f"launched")
        mem = doc["memory_analysis"]
        pred_ms = max(doc["t_compute"], doc["t_memory"]) * 1e3
        row = cells[name] = {
            "real_ms": ms, "pred_ms": pred_ms, "ratio": ms / pred_ms,
            "real_arg_bytes": real_args,
            "fake_arg_bytes": mem["argument_size_in_bytes"],
            "real_peak_bytes": real_peak,
            "fake_peak_bytes": mem["total_nonalias_bytes"],
            "batch": shape.global_batch, "seq_len": shape.seq_len,
            "noise_leaves_max_abs": max((d for _, d in noise), default=0.0)}
        row["peak_fake_over_real"] = row["fake_peak_bytes"] / real_peak
        print(f"  {name} ({shape.global_batch} x {shape.seq_len}): real "
              f"{ms:.3f} ms, predicted max(compute, memory) {pred_ms:.3f} "
              f"ms (ratio {ms / pred_ms:.2f}); peak real "
              f"{real_peak / 2**30:.3f} GiB, fake "
              f"{row['fake_peak_bytes'] / 2**30:.3f} GiB "
              f"({row['peak_fake_over_real']:.3f}); arguments {real_args} B "
              f"real, {row['fake_arg_bytes']} B fake; outputs equal the "
              f"plain function's bit for bit"
              + (f" but {', '.join(w.rsplit(']', 1)[-1] for w, _ in noise)} "
                 f"(zero gradient in exact arithmetic) within "
                 f"{row['noise_leaves_max_abs']:.2e}" if noise else ""),
              flush=True)
        need(real_args == row["fake_arg_bytes"],
             f"phase 3l {name}: argument bytes {real_args} real, "
             f"{row['fake_arg_bytes']} fake")
        need(row["fake_peak_bytes"] >= (1 - RANK_PEAK_UNDER) * real_peak,
             f"phase 3l {name}: the fake peak {row['fake_peak_bytes']} B is "
             f"more than {RANK_PEAK_UNDER:.0%} under the real {real_peak} B")
        del args, res, vals
        torch.cuda.empty_cache()


def counter_check(card, device="cuda"):
    """The cost counter on DTensors over fake ``device`` tensors, as this
    torch runs it: on a fake world of 16 ranks (a 4 x 4 ``data`` x
    ``model`` mesh) an FSDP x TP matmul counts the rank's local
    ``2 m k n``, its local operands' and output's bytes and exactly the
    all-gather of the weight's FSDP shard, and a second identical call
    counts what the first did (DTensor's sharding propagation, cached
    after the first call, is never counted: ``roofline._hide_propagation``
    raises where it cannot hide it); then qwen2-0.5b SMOKE's decode cell
    on a fake world of 256 counts the same twice.  No group may be alive
    in this process."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.configs import SHAPES, smoke_config
    from repro_torch.launch import dryrun, roofline
    F32 = 4
    want = (2 * 8 * 64 * 32, F32 * (8 * 64 + 64 * 32 + 8 * 32),
            F32 * 16 * 32)
    got = []
    with dryrun.fake_world(16):
        mesh = init_device_mesh(device, (4, 4),
                                mesh_dim_names=("data", "model"))
        mode = FakeTensorMode()
        with mode:
            x = DTensor.from_local(torch.zeros(8, 64, device=device), mesh,
                                   [Shard(0), Replicate()], run_check=False)
            w = DTensor.from_local(torch.zeros(16, 32, device=device), mesh,
                                   [Shard(0), Shard(1)], run_check=False)
        for _ in range(2):
            c = roofline.CostCounter()
            c.track_args((x, w))
            with mode, c:
                c.finish(torch.matmul(x, w))
            got.append((c.flops, c.bytes, sum(c.coll.values()),
                        c.coll["all_gather"]))
    need(got[0] == got[1], f"counter: a second matmul counted {got[1]}, "
         f"the first {got[0]}")
    need(got[0][:3] == want and got[0][3] == want[2],
         f"counter: the FSDP x TP matmul counted (FLOPs, bytes, collective "
         f"bytes, all-gather) {got[0]}, want {want + want[2:]}")
    cfg = smoke_config(LM_ARCH)
    shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=16,
                                global_batch=16)
    docs = []
    with dryrun.fake_world(256):
        mesh = init_device_mesh(device, (16, 16),
                                mesh_dim_names=("data", "model"))
        for _ in range(2):
            d = dryrun.run_cell(LM_ARCH, "decode_32k", mesh=mesh, cfg=cfg,
                                lm_shape=shape, out_dir=None, verbose=False)
            docs.append((d["flops_per_device"], d["bytes_per_device"],
                         d["coll_breakdown"]))
    need(docs[0] == docs[1], f"counter: {LM_ARCH} SMOKE decode counted "
         f"{docs[1]} the second time, {docs[0]} the first")
    print(f"{card}: counter on fake {device} DTensors (torch "
          f"{torch.__version__}): matmul {got[0][0]:.0f} FLOPs, "
          f"{got[0][1]:.0f} B, all-gather {got[0][3]:.0f} B, twice the same; "
          f"{LM_ARCH} SMOKE decode {docs[0][0]:.0f} FLOPs twice the same",
          flush=True)
    return {"matmul": got[0], "smoke_decode": docs[0][:2]}


# phase 3l: the committed dry-run records this torch's counts must equal
RECORDS = ROOT / "experiments" / "dryrun_torch"
SMOKE2X2 = RECORDS / "smoke2x2"
SMOKE2X2_ARCHS = ("jamba-v0.1-52b", "xlstm-350m")
RECORD_RTOL = 1e-6          # FLOPs, bytes and collective bytes a rank
RECORD_PEAK = 0.01          # the peak a rank


def record_check(doc, path, what):
    """Fails unless the dry-run ``doc`` counts what the committed record
    at ``path`` does: FLOPs, bytes and collective bytes a rank within
    RECORD_RTOL, the peak within RECORD_PEAK; returns the relative
    differences."""
    want = json.loads(Path(path).read_text())
    out = {}
    for k in ("flops_per_device", "bytes_per_device",
              "coll_bytes_per_device"):
        out[k] = (doc[k] - want[k]) / want[k] if want[k] else \
            float(doc[k] != 0)
        need(abs(out[k]) <= RECORD_RTOL, f"{what}: {k} {doc[k]!r} against "
             f"the record's {want[k]!r}")
    got, rec = (d["memory_analysis"]["total_nonalias_bytes"]
                for d in (doc, want))
    out["peak"] = got / rec - 1
    need(abs(out["peak"]) <= RECORD_PEAK, f"{what}: peak {got} B against "
         f"the record's {rec} B")
    return out


def lm_record_checks(pod, smoke, card):
    """Phase 3l's dry runs on this torch against the committed records
    (the CPU's, torch 2.13): qwen2-0.5b decode_32k's FLOPs on 256 fake
    ranks (its layouts stated by the model, not DTensor's strategy), and
    each cell of ``SMOKE2X2_ARCHS`` at SMOKE on a fake 2 x 2 world
    (``record_check``); qwen2-0.5b's other two cells printed beside their
    records."""
    import torch
    from repro_torch.configs import CELLS
    out = {}
    doc = pod["decode_32k"]
    rec = json.loads((RECORDS / f"pod16x16__{LM_ARCH}__decode_32k.json")
                     .read_text())
    rel = doc["flops_per_device"] / rec["flops_per_device"] - 1
    out["pod16x16 decode_32k flops"] = rel
    need(abs(rel) <= RECORD_RTOL, f"phase 3l: {LM_ARCH} decode_32k counts "
         f"{doc['flops_per_device']!r} FLOPs a rank, the record "
         f"{rec['flops_per_device']!r}")
    for name in ("train_4k", "prefill_32k"):
        want = json.loads((RECORDS / f"pod16x16__{LM_ARCH}__{name}.json")
                          .read_text())
        out[f"pod16x16 {name}"] = {k: pod[name][k] / want[k] - 1 for k in (
            "flops_per_device", "bytes_per_device", "coll_bytes_per_device")}
    for arch, docs in zip(SMOKE2X2_ARCHS, smoke):
        names = sorted(c["shape"].name for c in CELLS[arch]
                       if not c["skip"])
        need(sorted(docs) == names, f"phase 3l: the SMOKE 2 x 2 dry run of "
             f"{arch} wrote {sorted(docs)}, want {names}")
        for name in names:
            out[f"{arch} {name}"] = record_check(
                docs[name], SMOKE2X2 / f"mesh2x2__{arch}__{name}.json",
                f"phase 3l: {arch} {name} at SMOKE on 2 x 2")
    worst = max(abs(v) for k, r in out.items()
                if k.startswith(SMOKE2X2_ARCHS) for v in r.values())
    print(f"{card}: torch {torch.__version__}'s dry runs against the "
          f"records: {LM_ARCH} decode_32k FLOPs on 256 ranks {rel:+.2e}; "
          f"train_4k and prefill_32k "
          + "; ".join(f"{k.split()[1]} " + ", ".join(
              f"{x.split('_')[0]} {v:+.2e}" for x, v in out[k].items())
              for k in ("pod16x16 train_4k", "pod16x16 prefill_32k"))
          + f"; {', '.join(SMOKE2X2_ARCHS)} at SMOKE on 2 x 2, "
          f"{sum(len(d) for d in smoke)} cells, largest difference "
          f"{worst:.2e}", flush=True)
    return out


def lm_dryrun_start():
    """Phase 3l's dry runs, started: qwen2-0.5b's LM cells on a fake
    256-rank world and on a fake world of one at one rank's share, and
    the recurrent archs' (``SMOKE2X2_ARCHS``) at SMOKE on a fake 2 x 2
    world (the smoke starts them beside phase 3k's dry runs and collects
    them with those, before 3k's timed part: ``lm_dryrun_collect``)."""
    tmp = Path(tempfile.mkdtemp(prefix="lm_dryrun_"))
    return {"tmp": tmp, "t0": time.perf_counter(), "docs": None,
            "runs": dryrun_start(
                (tmp / "pod16x16", "--arch-filter", LM_ARCH),
                (tmp / "rank", "--arch-filter", LM_ARCH, "--mesh", "1x1",
                 "--sizing", "rank"),
                *((tmp / f"smoke_{a}", "--arch-filter", a, "--mesh", "2x2",
                   "--sizing", "smoke") for a in SMOKE2X2_ARCHS))}


def lm_dryrun_collect(lm):
    """Wait for ``lm``'s dry runs (``lm_dryrun_start``), once: their
    docs."""
    if lm["docs"] is None:
        t = time.perf_counter()
        lm["docs"] = dryrun_collect(lm["runs"])
        lm["dryruns_s"] = time.perf_counter() - lm["t0"]
        lm["wait_s"] = time.perf_counter() - t
    return lm["docs"]


def lm_dryrun_phase(report, card, started=None):
    """Phase 3l: qwen2-0.5b's LM cells through the dry run
    (``lm_dryrun_start``, unless ``started``), then one rank's share for
    real on the card over a one-rank NCCL group
    (``lm_rank_cell_checks``)."""
    import torch.distributed as dist
    out = report["lm_dryrun"] = {}
    t_phase = time.perf_counter()
    lm = started or lm_dryrun_start()
    tmp = lm["tmp"]
    docs, fake, *smoke = lm_dryrun_collect(lm)
    need(sorted(docs) == sorted(LM_SHAPES), f"the LM dry run wrote "
         f"{sorted(docs)}, want {sorted(LM_SHAPES)}")
    out["pod16x16"] = {k: {"gib": d["memory_analysis"]["total_nonalias_bytes"]
                           / 2**30, "fit": d["hbm_fit"],
                           "useful": d["useful_ratio"],
                           "bottleneck": d["bottleneck"],
                           "t_ms": {t: d[t] * 1e3 for t in (
                               "t_compute", "t_memory", "t_collective")}}
                       for k, d in docs.items()}
    out["dryruns_s"] = lm["dryruns_s"]
    out["dryruns_wait_s"] = lm["wait_s"]
    out["records"] = lm_record_checks(docs, smoke, card)
    out["counter"] = counter_check(card)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp / "store"), 1), rank=0, world_size=1)
    try:
        lm_rank_cell_checks(out, fake, card)
    finally:
        dist.destroy_process_group()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"{card}: phase 3l {out['phase_s']:.1f} s (its four dry runs "
          f"{out['dryruns_s']:.1f} s from their start, "
          f"{out['dryruns_wait_s']:.1f} s waited for, before 3k's "
          f"timing when 3k collected them)", flush=True)


# phase 3m: the LM cells on a real 2 x 2 mesh of four ranks on the card
LM_MESH_SHAPE = (2, 2)
LM_MESH_LAYERS = 2      # qwen2-0.5b's depth (FULL width), see lm_mesh_phase
LM_MESH_ARCHS = (LM_ARCH, "mixtral-8x7b", "jamba-v0.1-52b", "xlstm-350m")
# (seq_len, global batch) of each cell: qwen2-0.5b's, then the SMOKE archs'
LM_MESH_SIZES = {LM_ARCH: {"train_4k": (128, 4), "prefill_32k": (512, 2),
                           "decode_32k": (512, 2)},
                 "smoke": {"train_4k": (16, 2), "prefill_32k": (16, 4),
                           "decode_32k": (16, 4)}}
# the SMOKE archs train on one microbatch (a row a data rank): a MoE's aux
# loss is a statistic of each microbatch's routing, and the mesh's
# microbatch i is block i of every rank's rows, not the plain step's
# contiguous block i, so their microbatched steps differ by design
LM_MESH_POS = 5         # the decode step's position in its cache
LM_MESH_GRAPH = 12      # log2 vertices of the walk corpus's graph
LM_MESH_WALKERS = 256
LM_MESH_TIMEOUT_S = 420
# each collective kind's bytes a rank, against the dry run's prediction
LM_MESH_COLL_RTOL = 0.01
# the limits of tests/test_torch_launch_lm_numerics.py: the train step's
# loss and gradient norm (rtol), params and first moments (rtol, atol),
# second moments (rtol, atol); logits (rtol, atol of the largest); the
# written cache (one bf16 ulp, atol)
LM_MESH_TOL = {"metric": 1e-5, "param": (1e-5, 1e-6), "nu": (1e-5, 1e-9),
               "logits": (1e-5, 1e-5), "cache": (2.0 ** -7, 1e-6)}
# xlstm-350m's SMOKE stack is ill-conditioned at random init: summing in
# another order moves its train step's second moments by up to 4.6e-4
# relative on an H100 with torch 2.11.  Its cells are also run on
# whole tensors on the CPU, and the mesh run may use LM_MESH_FLOOR_X times
# the share of each limit that this CPU run uses, where that is more
LM_MESH_FLOOR = ("xlstm-350m",)
LM_MESH_FLOOR_X = 2.0
HOST_STAGED = "gloo_host"
STAGED_COUNTS: dict = {}    # kind -> [calls, bytes] (register_host_staging)


def register_host_staging():
    """Register ``HOST_STAGED``, a process group over gloo for ``cuda``
    and ``cpu`` tensors that stages each collective's CUDA buffers through
    the host: on the card's torch 2.11, gloo's own CUDA paths for the
    functional all-gather, and for DTensor's all-gathers, reduce-scatters
    and all-to-alls, kill the process (SIGSEGV in ``wait_tensor``).  The model
    issues the same collectives with the same bytes; only their transport
    changes.  Each call is tallied in ``STAGED_COUNTS`` by the counter's
    kinds (``roofline.COLLECTIVES``) and its input's bytes, as
    ``roofline.CostCounter`` counts them."""
    import torch
    import torch.distributed as dist
    from torch.futures import Future
    from torch.utils._python_dispatch import _disable_current_modes
    if HOST_STAGED in dist.Backend.backend_list:
        return

    def done(result):
        from torch._C._distributed_c10d import _create_work_from_future
        fut = Future()
        fut.set_result(result)
        return _create_work_from_future(fut)

    def tally(kind, tensors):
        row = STAGED_COUNTS.setdefault(kind, [0, 0])
        row[0] += 1
        row[1] += sum(t.numel() * t.element_size() for t in tensors)

    def host(ts):
        return [t.detach().to("cpu", copy=True) for t in ts]

    def reduce_options(opts):
        o = dist.AllreduceOptions()
        if opts is not None and hasattr(opts, "reduceOp"):
            o.reduceOp = opts.reduceOp
        return o

    class HostStaged(dist.ProcessGroup):
        def __init__(self, inner, rank, size, name):
            super().__init__(rank, size)
            self.inner, self._rank, self._size = inner, rank, size
            self._name = name

        @property
        def group_name(self):
            return self._name

        def getBackendName(self):
            return HOST_STAGED

        def size(self):
            return self._size

        def rank(self):
            return self._rank

        def allreduce(self, tensors, opts=None):
            with _disable_current_modes():
                tally("all_reduce", tensors)
                h = host(tensors)
                self.inner.allreduce(h, reduce_options(opts)).wait()
                for t, s in zip(tensors, h):
                    t.copy_(s)
            return done(tensors)

        allreduce_coalesced = allreduce

        def broadcast(self, tensors, opts=None):
            with _disable_current_modes():
                tally("broadcast", tensors)
                o = dist.BroadcastOptions()
                if opts is not None:
                    o.rootRank, o.rootTensor = opts.rootRank, opts.rootTensor
                h = host(tensors)
                self.inner.broadcast(h, o).wait()
                for t, s in zip(tensors, h):
                    t.copy_(s)
            return done(tensors)

        def allgather(self, outputs, inputs, opts=None):
            with _disable_current_modes():
                tally("all_gather", inputs)
                h = [host(ol) for ol in outputs]
                self.inner.allgather(h, host(inputs)).wait()
                for ol, hl in zip(outputs, h):
                    for t, s in zip(ol, hl):
                        t.copy_(s)
            return done(outputs)

        def _gather(self, outs, inps):
            with _disable_current_modes():
                tally("all_gather", inps)
                for out, inp in zip(outs, inps):
                    h = torch.empty(out.shape, dtype=out.dtype)
                    self.inner.allgather([list(h.chunk(self._size))],
                                         host([inp])).wait()
                    out.copy_(h)
            return done(outs)

        def _allgather_base(self, out, inp, opts=None):
            return self._gather([out], [inp])

        all_gather_single = _allgather_base

        def allgather_into_tensor_coalesced(self, outs, inps, opts=None):
            return self._gather(outs, inps)

        all_gather_single_coalesced = allgather_into_tensor_coalesced

        def _scatter(self, outs, inps, opts):
            # the reduction of the whole input, this rank's block kept
            with _disable_current_modes():
                tally("reduce_scatter", inps)
                for out, inp in zip(outs, inps):
                    h = host([inp.contiguous()])
                    self.inner.allreduce(h, reduce_options(opts)).wait()
                    out.copy_(h[0].chunk(self._size)[self._rank]
                              .reshape(out.shape))
            return done(outs)

        def _reduce_scatter_base(self, out, inp, opts=None):
            return self._scatter([out], [inp], opts)

        reduce_scatter_single = _reduce_scatter_base

        def reduce_scatter_tensor_coalesced(self, outs, inps, opts=None):
            return self._scatter(outs, inps, opts)

        reduce_scatter_single_coalesced = reduce_scatter_tensor_coalesced

        def reduce_scatter(self, outputs, input_lists, opts=None):
            return self._scatter(outputs, [torch.stack(list(il))
                                           for il in input_lists], opts)

        def alltoall_base(self, out, inp, out_splits, in_splits, opts=None):
            with _disable_current_modes():
                tally("all_to_all_single", [inp])
                h = torch.empty(out.shape, dtype=out.dtype)
                self.inner.alltoall_base(
                    h, host([inp.contiguous()])[0], list(out_splits),
                    list(in_splits), dist.AllToAllOptions()).wait()
                out.copy_(h)
            return done([out])

        all_to_all_single = alltoall_base

        def barrier(self, opts=None):
            self.inner.barrier(dist.BarrierOptions()).wait()
            return done([])

    def create(opts, backend_options=None):
        inner = dist.ProcessGroupGloo(opts.store, opts.group_rank,
                                      opts.group_size, opts.timeout)
        return HostStaged(inner, opts.group_rank, opts.group_size,
                          opts.group_id)

    dist.Backend.register_backend(HOST_STAGED, create, extended_api=True,
                                  devices=["cpu", "cuda"])


def cpu_mesh_kinds(coll):
    """A prediction's bytes by kind as a CPU mesh issues them: there
    DTensor moves a shard to another dim by an all-gather of the same
    input and a chunk (gloo has no all-to-all, it says), so the
    all-to-all's bytes are the all-gather's."""
    out = dict(coll)
    out["all_gather"] = out.get("all_gather", 0) + out.pop(
        "all_to_all_single", 0)
    return out


def lm_mesh_config(arch):
    """Phase 3m's config of ``arch``: qwen2-0.5b at FULL width cut to
    LM_MESH_LAYERS layers, the others at SMOKE; float32."""
    from repro_torch.configs import get_config, smoke_config
    if arch == LM_ARCH:
        return dataclasses.replace(get_config(arch), num_layers=LM_MESH_LAYERS,
                                   dtype="float32")
    return smoke_config(arch)


def lm_mesh_cells(archs=LM_MESH_ARCHS):
    """Phase 3m's cells: (arch, shape name, config, resized shape)."""
    from repro_torch.configs import SHAPES
    out = []
    for arch in archs:
        sizes = LM_MESH_SIZES.get(arch, LM_MESH_SIZES["smoke"])
        for name in LM_SHAPES:
            S, B = sizes[name]
            out.append((arch, name, lm_mesh_config(arch), dataclasses.replace(
                SHAPES[name], seq_len=S, global_batch=B)))
    return out


def lm_mesh_walk_batch(shape, device="cuda"):
    """qwen2-0.5b's train rows from the walk corpus: a deepwalk round (B1)
    of ``WalkCorpusPipeline`` on an R-MAT graph of 2^LM_MESH_GRAPH
    vertices (vertex ids are tokens of the vocabulary), seeded alike on
    every rank, its paths and pairs checked (``checked_pipeline``)."""
    from repro_torch.core.dyngraph import BingoConfig, from_edges
    from repro_torch.graph.rmat import degree_bias, rmat_edges
    V = 1 << LM_MESH_GRAPH
    src, dst = rmat_edges(LM_MESH_GRAPH, 8, seed=0)
    w = degree_bias(src, dst, V, bias_bits=TRAIN_BITS)
    bcfg = BingoConfig(num_vertices=V, capacity=TRAIN_CAPACITY,
                       bias_bits=TRAIN_BITS)
    state = from_edges(bcfg, src, dst, w, device=device)
    pipe = checked_pipeline(state, bcfg, walkers_per_round=LM_MESH_WALKERS,
                            seq_len=shape.seq_len,
                            batch_size=shape.global_batch)
    batch = next(pipe)
    need(pipe.rounds >= 1 and pipe.walk_err == 0.0, "phase 3m: no walk "
         "round checked")
    return batch


def whole_tree(tree):
    """``tree`` with each DTensor gathered whole (a collective)."""
    from torch.utils._pytree import tree_map
    return tree_map(lambda t: t.full_tensor() if type(t).__name__ ==
                    "DTensor" else t, tree)


def mesh_ratio(got, want, rtol, atol):
    """The largest |got - want| / (atol + rtol |want|) over the leaves of
    two trees (at most 1: within the limit)."""
    import torch
    from torch.utils._pytree import tree_flatten
    g, w = tree_flatten(got)[0], tree_flatten(want)[0]
    need(len(g) == len(w), "phase 3m: the trees differ")
    worst = 0.0
    for a, b in zip(g, w):
        if not isinstance(b, torch.Tensor) or not b.is_floating_point():
            need(bool(torch.equal(a, b)) if isinstance(b, torch.Tensor)
                 else a == b, "phase 3m: a leaf differs")
            continue
        a, b = a.double(), b.double()
        worst = max(worst, float(((a - b).abs() / (atol + rtol * b.abs()))
                                 .max()))
    return worst


def lm_mesh_excess(name, got, want):
    """The cell's outputs against the plain run's, each group's largest
    ratio to its limit in LM_MESH_TOL."""
    t = LM_MESH_TOL
    if name == "train_4k":
        (p, o, _, m), (pw, ow, _, mw) = got, want
        return {"loss": mesh_ratio(m["loss"], mw["loss"], t["metric"], 0.0),
                "grad_norm": mesh_ratio(m["grad_norm"], mw["grad_norm"],
                                        t["metric"], 0.0),
                "params": mesh_ratio(p, pw, *t["param"]),
                "mu": mesh_ratio(o.mu, ow.mu, *t["param"]),
                "nu": mesh_ratio(o.nu, ow.nu, *t["nu"]),
                "step": float(int(o.step) != int(ow.step))}
    decode = name == "decode_32k"
    logits, lw = (got[0], want[0]) if decode else (got, want)
    rtol, atol = t["logits"]
    out = {"logits": mesh_ratio(logits, lw, rtol,
                                atol * float(lw.abs().max()))}
    if decode:
        out["cache"] = mesh_ratio(got[1], want[1], *t["cache"])
    return out


def on_device(tree, device):
    """A copy of ``tree`` with its tensors on ``device``."""
    import torch
    from torch.utils._pytree import tree_map
    return tree_map(lambda t: t.to(device, copy=True)
                    if isinstance(t, torch.Tensor) else t, tree)


def lm_mesh_rank(rank, n, backend, tmp):
    """One rank of phase 3m (runs in its own process): the cells of
    ``lm_mesh_cells`` (``job.json``'s archs) on ``init_device_mesh(device,
    LM_MESH_SHAPE)`` over a ``HOST_STAGED`` world; rank 0 holds each
    against the plain run."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.kernels import ops
    from repro_torch.launch.specs import build_cell, place
    tmp = Path(tmp)
    job = json.loads((tmp / "job.json").read_text())
    device = job["device"]
    card = device == "cuda"
    if card:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    register_host_staging()
    dist.init_process_group(HOST_STAGED, store=dist.FileStore(
        str(tmp / "store"), n), rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=LM_MESH_TIMEOUT_S))
    res = {"cells": {}}
    try:
        mesh = init_device_mesh(device, LM_MESH_SHAPE,
                                mesh_dim_names=("data", "model"))
        for arch, name, cfg, shape in lm_mesh_cells(job["archs"]):
            key = f"{arch} {name}"
            cell = build_cell(arch, name, mesh, cfg=cfg, shape=shape)
            batch = None
            if name == "train_4k" and arch == LM_ARCH:
                batch = lm_mesh_walk_batch(shape, device)
                res["walk_batch"] = digest(list(batch.values()))
            vals = lm_inputs(name, shape, cfg, batch, device, LM_MESH_POS)
            plain = clone_tree(vals) if rank == 0 else None
            args = place(vals, cell.specs, mesh)
            del vals
            before = 0
            if card:
                torch.cuda.empty_cache()
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            STAGED_COUNTS.clear()
            t0 = time.perf_counter()
            got = cell.fn(*args)
            if card:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - before if card \
                else None
            # a copy of each [calls, bytes]: the tally goes on counting
            # (the outputs' full_tensor gathers below, the next cell)
            row = {"wall_s": wall,
                   "coll": {k: list(v) for k, v in STAGED_COUNTS.items()},
                   "peak_bytes": peak if peak is None else
                   peak + storage_bytes(local_tree(args)),
                   "microbatches": cell.meta.get("plan", {}).get(
                       "microbatches")}
            got = whole_tree(got)
            del args
            if plain is not None:
                floor = on_device(cell.fn(*on_device(plain, "cpu")), device) \
                    if arch in LM_MESH_FLOOR else None
                want = cell.fn(*plain)
                row["excess"] = lm_mesh_excess(name, got, want)
                if floor is not None:
                    row["floor_excess"] = lm_mesh_excess(name, floor, want)
                del want, plain, floor
            res["cells"][key] = row
            del got
            if card:
                torch.cuda.empty_cache()
        res["launches"] = ops.launch_counts()
    finally:
        dist.destroy_process_group()
    (tmp / f"result_{backend}_{rank}.json").write_text(json.dumps(res))


def lm_mesh_predictions(device="cuda", archs=LM_MESH_ARCHS):
    """Each phase-3m cell on a fake world of LM_MESH_SHAPE's size, fake
    ``device`` tensors (the dry run's counter): its peak, FLOPs, bytes and
    collective bytes by kind a rank.  No group may be alive in this
    process."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import dryrun
    out = {}
    with dryrun.fake_world(math.prod(LM_MESH_SHAPE)):
        mesh = init_device_mesh(device, LM_MESH_SHAPE,
                                mesh_dim_names=("data", "model"))
        for arch, name, cfg, shape in lm_mesh_cells(archs):
            d = dryrun.run_cell(arch, name, mesh=mesh, cfg=cfg,
                                lm_shape=shape, out_dir=None, verbose=False)
            out[f"{arch} {name}"] = {
                "peak_bytes": d["memory_analysis"]["total_nonalias_bytes"],
                "flops": d["flops_per_device"],
                "bytes": d["bytes_per_device"],
                "coll": d["coll_breakdown"]}
    return out


def lm_mesh_phase(report, card, device="cuda", archs=LM_MESH_ARCHS):
    """Phase 3m: the LM cells (``lm_mesh_cells``) on a real 2 x 2 mesh of
    four ranks sharing the card over a ``HOST_STAGED`` world (gloo through
    the host), each held on rank 0 against the same function on plain
    whole tensors on the card in float32 with TF32 off, at
    LM_MESH_TOL's limits; each cell's wall time, collectives and peak a
    rank printed beside the counter's prediction for the same cell on a
    fake 2 x 2 world (``lm_mesh_predictions``, run here while the ranks
    start).  qwen2-0.5b runs at FULL width cut to LM_MESH_LAYERS layers:
    every collective crosses the host twice, and two layers hold every
    layout of its stack (the stage is one slot repeated).  Returns the
    ranks' launches by kernel (B1: the train rows' walk round).
    ``device="cpu"`` and fewer ``archs`` make the CPU test's run (no
    peaks there).  Each collective kind's bytes a rank must equal the
    prediction within LM_MESH_COLL_RTOL in every cell (checked after all
    cells are printed; on a CPU mesh with its all-to-alls counted as the
    all-gathers DTensor issues there, ``cpu_mesh_kinds``)."""
    out = report["lm_mesh"] = {}
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="lm_mesh_"))
    (tmp / "job.json").write_text(json.dumps({
        "device": device, "archs": list(archs)}))
    preds = {}
    results = spawn_ranks(tmp, "gloo", math.prod(LM_MESH_SHAPE),
                          target=lm_mesh_rank, timeout=LM_MESH_TIMEOUT_S,
                          meanwhile=lambda: preds.update(
                              lm_mesh_predictions(device, archs)))
    digests = {r.get("walk_batch") for r in results}
    need(len(digests) == 1, f"phase 3m: the ranks' walk rows differ "
         f"({digests})")
    cells = out["cells"] = {}
    coll_off = []
    for key in results[0]["cells"]:
        ranks = [r["cells"][key] for r in results]
        ex = ranks[0]["excess"]
        floor = ranks[0].get("floor_excess")
        limit = {k: max(1.0, LM_MESH_FLOOR_X * floor[k]) if floor else 1.0
                 for k in ex}
        p = preds[key]
        want_coll = p["coll"] if device == "cuda" else cpu_mesh_kinds(
            p["coll"])
        coll = [{k: v[1] for k, v in r["coll"].items()} for r in ranks]
        row = cells[key] = {
            "wall_s": max(r["wall_s"] for r in ranks), "excess": ex,
            "floor_excess": floor, "limit": limit,
            "coll_bytes": coll, "coll_calls": [
                {k: v[0] for k, v in r["coll"].items()} for r in ranks],
            "peak_bytes": [r["peak_bytes"] for r in ranks],
            "pred": p, "microbatches": ranks[0]["microbatches"]}
        real_c = [sum(c.values()) for c in coll]
        pred_c = sum(p["coll"].values())
        row["coll_real_over_pred"] = [c / pred_c if pred_c else None
                                      for c in real_c]
        for r, c in enumerate(coll):
            for kind in set(c) | {k for k, v in want_coll.items() if v}:
                got, want = c.get(kind, 0), want_coll.get(kind, 0)
                if abs(got - want) > LM_MESH_COLL_RTOL * want:
                    coll_off.append(f"{key} rank {r} {kind}: {got} bytes, "
                                    f"predicted {want}")
        peaks = [b for b in row["peak_bytes"] if b is not None]
        row["peak_real_over_pred"] = [b / p["peak_bytes"] for b in peaks]
        mb = row["microbatches"] or 1
        calls = ", ".join(f"{k} {v[0]} calls {v[1] / 2**20:.3f} MiB "
                          f"(predicted {want_coll.get(k, 0) / 2**20:.3f})"
                          for k, v in ranks[0]["coll"].items())
        print(f"  {key} ({mb} microbatch{'es' if mb > 1 else ''}): wall "
              f"{row['wall_s']:.2f} s (DTensor's planning included); "
              f"share of each limit used "
              + ", ".join(f"{k} {v:.3f}" for k, v in ex.items())
              + ("" if not floor else " (the plain run on the CPU: "
                 + ", ".join(f"{k} {v:.3f}" for k, v in floor.items())
                 + f"; allowed {LM_MESH_FLOOR_X:g} times that)")
              + f"; collectives a rank {min(real_c) / 2**20:.3f}-"
              f"{max(real_c) / 2**20:.3f} MiB (rank 0: {calls}), "
              f"predicted {pred_c / 2**20:.3f}; peak a rank "
              + (f"{min(peaks) / 2**20:.1f}-{max(peaks) / 2**20:.1f} MiB"
                 if peaks else "not measured")
              + f", predicted {p['peak_bytes'] / 2**20:.1f}", flush=True)
        need(all(v <= limit[k] for k, v in ex.items()), f"phase 3m {key}: "
             f"the mesh run outside its limits against the plain run: {ex} "
             f"(allowed {limit})")
    need(not coll_off, "phase 3m: collective bytes a rank off the "
         f"prediction by more than {LM_MESH_COLL_RTOL:.0%}: "
         + "; ".join(coll_off))
    launches = {}
    for r in results:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    need(device != "cuda" or LM_ARCH not in archs or
         launches.get("walk_fused", 0) >= len(results), f"phase 3m: the "
         f"walk rounds launched {launches}")
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"{card}: phase 3m {out['phase_s']:.1f} s ({len(cells)} cells on a "
          f"{LM_MESH_SHAPE[0]} x {LM_MESH_SHAPE[1]} mesh of "
          f"{len(results)} ranks, every one within its limits and its "
          f"collectives within {LM_MESH_COLL_RTOL:.0%} of the prediction)",
          flush=True)
    return launches


def attention_pairs(S, T, causal, window):
    """Unmasked (query, key) pairs of one head: query row i at i + T - S."""
    qpos = np.arange(S, dtype=np.int64) + (T - S)
    hi = np.minimum(T, qpos + 1) if causal else np.full(S, T, np.int64)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(S, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def sdpa_ms(q, k, v, **kw):
    """``(ms, output, backend)`` of one ``scaled_dot_product_attention``
    call on the same tensors (``enable_gqa``: KV not repeated): on its
    fused backends, or, where none takes the input (float32 with grouped
    KV heads) and the whole (B, H, S, T) float32 logits are at most
    SDPA_MATH_LOGITS bytes, on its math backend, which holds them."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def call():
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
             SDPBackend.EFFICIENT_ATTENTION]
    try:
        with sdpa_kernel(fused):
            return (*cuda_ms(call), "fused")
    except RuntimeError as e:
        logits = 4 * q.shape[0] * q.shape[1] * q.shape[2] * k.shape[2]
        if logits > SDPA_MATH_LOGITS:
            raise RuntimeError(f"no fused backend, and the math backend's "
                               f"{logits / 1e9:.1f} GB of logits are over "
                               f"SDPA_MATH_LOGITS: {e}") from e
    with sdpa_kernel([SDPBackend.MATH]):
        return (*cuda_ms(call), "math")


def attention_phase(report):
    """Phase 3e: flash attention at full width over one sequence, every
    case of ``ATTN_CASES``: Mixtral 8x7B's widths over 32,768 tokens in
    bf16 windowed and full causal and f32 windowed, hubert-xlarge's (16
    heads, MHA, D = 80, non-causal) in bf16 (zero-padded to D = 128) and
    f32 (80 wide); over 8,192 tokens Gemma 2 9B's (D = 256, window 4096)
    in bf16, f16 and f32, D = 200 (zero-padded to 256), Mixtral's widths
    in f16, qwen2-0.5b's (D = 64) in all three types and Gemma's heads
    and window at D = 512 and 384 in all three types.  Each case is
    one launch of its instantiation (the route's counter), held against
    its plain version at its limit and, on 256 sampled rows, against the
    dense ``attention_ref`` in f32, with a planted fault that both must
    reject; timed (CUDA events, median of 3) beside its bound, its plain
    version and SDPA (``sdpa_ms``: its math backend where no fused one
    takes the input; null where the math backend's logits would not fit
    either).  Returns the kernels' lines: the two routes as before (bf16:
    Mixtral's full-causal case beside SDPA's ``is_causal``; f32: the
    window over 32,768 tokens beside SDPA with a mask, which no SDPA
    backend takes), then each other instantiation from its first case."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_ref,
                                                     flash_attention_ref32,
                                                     kernel_head_dim)
    g = torch.Generator(device="cuda").manual_seed(11)
    base = {}          # (H, Hkv, D, S) -> bf16 q, k, v; f32 and f16 widen

    def qkv(H, Hkv, D, S, dtype):
        key = (H, Hkv, D, S)
        if key not in base:
            base[key] = tuple(torch.randn(shape, generator=g,
                                          device="cuda").to(torch.bfloat16)
                              for shape in ((1, H, S, D), (1, Hkv, S, D),
                                            (1, Hkv, S, D)))
        return tuple(x.to(getattr(torch, dtype)) for x in base[key])

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    outs, launched = {}, {}
    for name, H, Hkv, D, S, dt, c, w in ATTN_CASES:
        before = ops.launch_counts()
        outs[name] = ops.flash_attention(*qkv(H, Hkv, D, S, dt), causal=c,
                                         window=w)
        after = ops.launch_counts()
        launched[name] = {k: after[k] - before[k] for k in after
                          if after[k] != before[k]}
        need(launched[name] == {flash_route(dt): 1}, f"attention {name}: "
             f"launches {launched[name]}")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"attention ({len(ATTN_CASES)} cases), launches: {counts}",
          flush=True)
    need(counts["flash_attention_sm90"] == sum(
        dt != "float32" for *_, dt, _, _ in ATTN_CASES)
        and counts["flash_attention"] == sum(
            dt == "float32" for *_, dt, _, _ in ATTN_CASES)
        and sum(counts.values()) == len(ATTN_CASES),
        f"phase 3e launches {counts}")

    def dense_excess(o, plain, x, causal, w, S):
        """``o``'s 256 sampled rows against the dense ``attention_ref`` in
        f32: entry by entry in f32, row by row (with ``plain``) in 16
        bits."""
        qf, kf, vf = (t.float() for t in x)
        worst = 0.0
        for a in (min(a, S - 64) for a in (0, ATTN_WINDOW - 32,
                                           S // 2 + 320, S - 64)):
            rows = slice(a, a + 64)
            dense = attention_ref(qf[:, :, rows], kf, vf, causal=causal,
                                  window=w, q_offset=a)
            worst = max(worst, flash_excess(o[:, :, rows], dense, "float32")
                        if o.dtype == torch.float32 else flash_row_excess(
                            o[:, :, rows], plain[:, :, rows], dense))
        return worst

    out = {}
    for name, H, Hkv, D, S, dt, causal, w in ATTN_CASES:
        q, k, v = x = qkv(H, Hkv, D, S, dt)
        o = outs.pop(name)
        need(o.shape == q.shape and o.dtype == q.dtype
             and bool(torch.isfinite(o).all()), f"attention {name}: output")
        fault = ops.flash_attention(q, k, v, causal=causal,
                                    window=shifted_window(S, w))
        ms, _ = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                                    window=w))
        plain_ms, plain = cuda_ms(lambda: flash_attention_ref(
            q, k, v, causal=causal, window=w), reps=1)
        ref32 = flash_attention_ref32(q, k, v, causal=causal, window=w) \
            if q.dtype != torch.float32 else None
        dense, dense_fault = dense_excess(o, plain, x, causal, w, S), \
            dense_excess(fault, plain, x, causal, w, S)
        need(dense <= 1 < dense_fault, f"attention {name}: 256 rows vs "
             f"attention_ref at {dense:.3f} of the limit, the planted fault "
             f"at {dense_fault:.3f}")
        err = float((o.float() - plain.float()).abs().max())
        fault_err = float((fault.float() - plain.float()).abs().max())
        excess = flash_limit(o, plain, ref32)
        fault_excess = flash_limit(fault, plain, ref32)
        old = None if q.dtype != torch.bfloat16 else (
            flash_excess(o, plain, "bfloat16"),
            flash_excess(fault, plain, "bfloat16"))
        del plain, ref32, fault
        need(excess <= 1 < fault_excess, f"attention {name}: kernel at "
             f"{excess:.3f} of the limit (max abs vs plain {err}), the "
             f"planted fault at {fault_excess:.3f}")
        is16 = q.dtype != torch.float32
        width = kernel_head_dim(D, q.dtype)
        pairs = H * attention_pairs(S, S, causal, w)
        flops = 4 * D * pairs
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        # the card's peak for the type: 16-bit tensor cores; f32 to f32
        # accuracy on the tensor cores is three TF32 products
        work, rate = (flops, hw.PEAK_FLOPS_BF16) if is16 else \
            (3 * flops, hw.TC_TF32_FLOPS)
        b_ms = max(work / rate, nbytes / hw.HBM_BW) * 1e3
        b_by = "operations" if work / rate >= nbytes / hw.HBM_BW \
            else "bytes"
        old_b_ms = None if is16 else max(
            flops / hw.OPS_PER_S, nbytes / hw.HBM_BW) * 1e3
        # the yardstick: a library fault does not fail the smoke; SDPA's
        # backend is recorded in "library", and where it has none for
        # these inputs (f32 with grouped KV heads and logits over
        # SDPA_MATH_LOGITS) its error and each fused backend's reason,
        # from its warnings, without a traceback
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                if w:
                    pos = torch.arange(S, device="cuda")
                    mask = ((pos[None, :] <= pos[:, None])
                            & (pos[None, :] > pos[:, None] - w))
                    lib_ms, lib, how = sdpa_ms(q, k, v, attn_mask=mask)
                    del mask
                else:
                    lib_ms, lib, how = sdpa_ms(q, k, v, is_causal=causal)
                lib_err = float((lib.float() - o.float()).abs().max())
                del lib
            except Exception as e:              # noqa: BLE001
                why = sorted({str(m.message).strip().splitlines()[0]
                              for m in caught})
                lib_ms, lib_err = None, None
                how = (f"no time: {type(e).__name__}: "
                       f"{str(e).strip().splitlines()[0]}"
                       + (f" ({'; '.join(why)})" if why else ""))[:600]
        out[name] = {"window": w, "causal": causal, "heads": H,
                     "kv_heads": Hkv, "head_dim": D, "width": width,
                     "seq": S, "dtype": str(q.dtype),
                     "launches": launched[name], "ms": ms,
                     "plain_ms": plain_ms, "max_abs_err": err,
                     "excess": excess, "fault_max_abs_err": fault_err,
                     "fault_excess": fault_excess, "old_tol_excess": old,
                     "dense_rows_excess": dense,
                     "dense_rows_fault_excess": dense_fault,
                     "pairs": pairs, "flops": flops, "bytes": nbytes,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "cuda_core_bound_ms": old_b_ms,
                     "share_of_bound": b_ms / ms, "library_ms": lib_ms,
                     "library": how, "library_vs_kernel_err": lib_err,
                     "tflops": flops / ms / 1e9}
        print(f"flash_attention {name} (S=T={S}, H={H}, Hkv={Hkv}, D={D}"
              f"{'' if width == D else f' run at {width}'}, "
              f"{dt}, {'causal' if causal else 'non-causal'}, window {w}): "
              f"{ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
              f"{100 * b_ms / ms:.1f} % of the bound), {pairs / 1e9:.3f} G "
              f"pairs -> bound {b_ms:.3f} ms ({b_by}, {work / 1e12:.3f} "
              f"TFLOP at {rate / 1e12:.1f} TFLOP/s"
              + ("" if old_b_ms is None else f"; at the f32 CUDA-core rate "
                 f"{old_b_ms:.3f} ms, for the record")
              + f"); plain {plain_ms:.1f} ms, "
              f"max abs {err:.5f}; share of the limit {excess:.3f} (planted "
              f"fault: max abs {fault_err:.5f}, {fault_excess:.1f} of the "
              f"limit), 256 rows vs dense attention_ref {dense:.3f} (fault "
              f"{dense_fault:.1f})"
              + ("" if old is None else f"; old FLASH_TOL vs plain (record "
                 f"only) {old[0]:.3f}, fault {old[1]:.1f}")
              + f"; sdpa "
              f"{'not timed' if lib_ms is None else f'{lib_ms:.3f} ms'} "
              f"({how}, vs kernel {lib_err})", flush=True)
        del o
    report["attention"] = out
    return attention_lines(out, counts)


ATTN_SOURCES = {"flash_attention_sm90":
                "src/repro_torch/csrc/flash_attention_sm90.cu",
                "flash_attention": "src/repro_torch/csrc/flash_attention.cu"}


def attention_lines(out, counts):
    """The kernels' lines of phase 3e's cases ``out``: the two routes
    under their wrappers' names (every launch of the route; the bf16
    full-causal and the f32 window case's numbers, as earlier runs
    printed them), then each instantiation the two do not stand for, as
    ``route[type, width]``, from its first case (its launches and the
    largest error over its cases)."""
    def line(name, route, pipe, cases, launches):
        c = out[cases[0]]
        return {"name": name, "route": "cuda", "pipe": pipe,
                "source": ATTN_SOURCES[route],
                "replaces": "src/repro/kernels/flash_attention.py:102",
                "launches": launches,
                "max_abs_err": max(out[n]["max_abs_err"] for n in cases),
                "ms": c["ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "library_ms": c["library_ms"],
                "library_backend": c["library"] if c["library_ms"] is not None
                else None}

    def pipe(dtype, width):
        return ("wgmma" if dtype != "torch.float32" else "wgmma 3xtf32") + (
            ", columns split over blocks" if width > 256 else "")
    groups = {}
    for name, r in out.items():
        groups.setdefault((r["dtype"], r["width"]), []).append(name)
    lines = [line("flash_attention_sm90", "flash_attention_sm90", "wgmma",
                  ["causal"] + [n for n, r in out.items()
                                if r["dtype"] != "torch.float32"
                                and n != "causal"],
                  counts["flash_attention_sm90"]),
             line("flash_attention", "flash_attention", "wgmma 3xtf32",
                  ["window f32"] + [n for n, r in out.items()
                                    if r["dtype"] == "torch.float32"
                                    and n != "window f32"],
                  counts["flash_attention"])]
    for (dtype, width), names in sorted(groups.items()):
        short = dtype.replace("torch.", "").replace("bfloat16", "bf16") \
            .replace("float16", "f16").replace("float32", "f32")
        rt = "flash_attention" if dtype == "torch.float32" else \
            "flash_attention_sm90"
        if (rt, short, width) in (("flash_attention_sm90", "bf16", 128),
                                  ("flash_attention", "f32", 128)):
            continue
        lines.append(line(f"{rt}[{short},{width}]", rt, pipe(dtype, width),
                          names, sum(sum(out[n]["launches"].values())
                                     for n in names)))
    return lines


def profiled(fn, trace, what, keep=True):
    """Run ``fn()`` once under ``torch.profiler``: its host wall time, the
    device's busy time (union of kernel, copy and set intervals) and the
    device time by kernel name.  Writes the Chrome trace to ``trace`` and
    keeps it if ``keep``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    trace.parent.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text()).get("traceEvents", [])
    if not keep:
        trace.unlink()
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                  e.get("name", "?")) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    by_name = {}
    for a, b, name in dev:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + (b - a) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"wall_ms": wall_ms, "device_events": len(dev),
           "device_busy_ms": busy / 1e3,
           "busy_share": busy / 1e3 / wall_ms if dev else None,
           "device_ms_by_name": dict(top)}
    if dev:
        print(f"profiled {what}: {wall_ms:.2f} ms wall, device busy "
              f"{busy / 1e3:.2f} ms ({100 * busy / 1e3 / wall_ms:.1f} %) in "
              f"{len(dev)} device events; by name (ms): "
              f"{', '.join(f'{k} {v:.3f}' for k, v in top)}", flush=True)
    else:
        print(f"profiled {what}: {wall_ms:.2f} ms wall; the profiler saw no "
              f"device events (device time not measured)", flush=True)
    return out


def trace_counts(events, span=None):
    """What a ``torch.profiler`` Chrome trace holds: top-level host ops,
    device events (kernels, memsets, memcpys) and host syncs (count and
    ms waiting), the host span and the device's busy ms and idle share
    over its own span.  With ``span`` (t0, t1) in the trace's µs: only
    host calls inside it and the device events they launched."""
    t0, t1 = span if span else (float("-inf"), float("inf"))
    inside = [e for e in events if t0 <= float(e.get("ts", 0)) <= t1]
    host = sorted((e for e in inside if e.get("cat") == "cpu_op"),
                  key=lambda e: float(e["ts"]))
    top, end = [], float("-inf")
    for e in host:
        if float(e["ts"]) >= end:
            top.append(e)
            end = float(e["ts"]) + float(e.get("dur", 0))
    # launches through the runtime API and, cuBLAS's among them, through
    # the driver API
    rt = [e for e in inside
          if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    corr = {e.get("args", {}).get("correlation") for e in rt}
    dev = sorted((e for e in events
                  if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")
                  and e.get("args", {}).get("correlation") in corr),
                 key=lambda e: float(e["ts"]))
    syncs = [e for e in rt if "Synchronize" in e.get("name", "")]
    busy, last = 0.0, float("-inf")
    for e in dev:
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        busy += max(0.0, b - max(a, last))
        last = max(last, b)
    dspan = (last - float(dev[0]["ts"])) if dev else 0.0
    return {"host_ops": len(top),
            "device_events": len(dev),
            "kernels": sum(e["cat"] == "kernel" for e in dev),
            "memsets": sum(e["cat"] == "gpu_memset" for e in dev),
            "memcpys": sum(e["cat"] == "gpu_memcpy" for e in dev),
            "syncs": len(syncs),
            "sync_ms": sum(float(e.get("dur", 0)) for e in syncs) / 1e3,
            "host_ms": ((max(float(e["ts"]) + float(e.get("dur", 0))
                             for e in top) - float(top[0]["ts"])) / 1e3
                        if top else 0.0),
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1 - busy / dspan if dspan else None}


def annotation_span(events, name):
    """(t0, t1) of the first ``record_function(name)`` span of a trace, in
    its µs, or None."""
    ann = [e for e in events if e.get("name") == name
           and e.get("cat") == "user_annotation"]
    if not ann:
        return None
    t0 = float(ann[0]["ts"])
    return t0, t0 + float(ann[0]["dur"])


def profile_round(state, cfg, lanes, starts, out_dir):
    """One serving round (``ingest`` of the last round's lanes, then a
    deepwalk batch) under ``torch.profiler``, after a warm-up round; the
    ingest's own counts (``trace_counts`` over its ``record_function``
    span) beside the round's."""
    import torch
    from repro_torch.core.walks import WalkParams
    from repro_torch.serve import DynamicWalkEngine
    eng = DynamicWalkEngine(clone_state(state), cfg,
                            WalkParams("deepwalk", WALK_LEN), seed=1)
    eng.ingest(*lanes)
    eng.walk(starts)
    eng = DynamicWalkEngine(state, cfg, WalkParams("deepwalk", WALK_LEN),
                            seed=1)

    def round_():
        with torch.profiler.record_function("ingest"):
            eng.ingest(*lanes)
        eng.walk(starts)
    trace = out_dir / "round_trace.json"
    out = profiled(round_, trace, "round")
    events = json.loads(trace.read_text()).get("traceEvents", [])
    span = annotation_span(events, "ingest")
    if span:
        out["ingest"] = trace_counts(events, span)
        print(f"profiled round, ingest of {int(lanes[0].shape[0])} updates: "
              f"{out['ingest']}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20,
                    help="log2 of the vertex count of the main path's graph")
    ap.add_argument("--report", type=Path, default=None,
                    help="write every number measured to this JSON file")
    ap.add_argument("--profile", type=Path, default=None,
                    help="after the main path, profile one round and write "
                         "its trace into this directory")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {"scale": args.scale}

    t_start = time.perf_counter()
    phase_s = report["phase_s"] = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t
        return out

    # ---- phase 1: build and report
    secs = _build.build_all()
    report["build_s"] = secs
    print(f"built {list(_build.SOURCES)} in {secs:.1f} s", flush=True)
    for name, log in _build.BUILD_LOG.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln
                or "spill" in ln]
        print(f"  {name}: {'; '.join(regs)}", flush=True)
    report["sm90"] = sm90_census()
    report["walk_census"] = walk_census()
    report["table_census"] = table_census()
    card = card_line()
    report["card"] = card
    torch.cuda.init()
    phase_s["1 build and census"] = time.perf_counter() - t_start

    # ---- phase 2: kernel == plain on the card
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    checks = report["check_parts_s"] = {}

    def part(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        checks[name] = time.perf_counter() - t
        return out
    nw = part("walk_fused", check_walk_kernel, rng)
    ng = part("walk_segment", check_segment_kernel, rng)
    nu = part("update_fused", check_update_kernel, rng)
    ns = part("walk_sample", check_sample_kernels, rng)
    rng_new = np.random.default_rng(1)       # rng's stream stays as it was
    nt = part("tables", check_table_kernels, rng_new)
    fa_errs = part("flash_attention", check_flash_kernel, rng_new)
    report["check_s"] = phase_s["2 kernel == plain"] = \
        time.perf_counter() - t0
    report["flash_check_errs"] = fa_errs
    print(f"kernel == plain, bit-exact: walk_fused {nw} cases, walk_segment "
          f"{ng} cases, update_fused {nu} rounds, walk_sample and "
          f"walk_sample_uniform {ns} cases each, radix_hist and alias_build "
          f"{nt} cases; flash_attention {len(fa_errs)} cases within "
          f"its limit ({report['check_s']:.1f} s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in checks.items()) + ")",
          flush=True)
    for e in fa_errs:
        old = e["old_tol_excess"]
        print(f"  flash_attention {e['case']}: max abs vs plain "
              f"{e['max_abs_err']:.2e}, {e['excess']:.3f} of the limit; "
              f"planted fault {e['fault_max_abs_err']:.2e}, "
              f"{e['fault_excess']:.1f} of it"
              + ("" if old is None else f"; old FLASH_TOL (record only): "
                 f"{old[0]:.3f}, fault {old[1]:.1f}"), flush=True)

    # ---- phases 3 and 4: the main path, then the times
    kernels, engine, cfg, starts, stream, graph, profile = timed(
        "3/4 main path and times", main_path, args, report)
    # ---- phase 3d: the table kernels on the final state
    tables = timed("3d table kernels", table_phase, engine, cfg, report)
    # ---- phase 3b: the per-step paths
    kernels += timed("3b per-step paths", per_step_paths, engine, cfg,
                     starts, report, args.profile)
    if profile is not None:         # after the profiler-counted replays
        timed("profiled round", profile)
        profile = None              # frees the round's saved state
    # ---- phase 3c: the sharded path, then the streaming updates
    mesh_h = {}
    kernels.insert(1, timed("3c sharded path", sharded_path, engine, cfg,
                            starts, stream, report, mesh_h))
    timed("streaming updates", streaming, engine, cfg, report, rng)
    kernels += tables
    del engine
    torch.cuda.empty_cache()
    # ---- phase 3f: the serving layer at full width, then recovery
    peak = torch.cuda.max_memory_allocated()
    handoff = {"V": 1 << args.scale}
    timed("3f serving", serving_phase, args, report, graph, stream, handoff)
    timed("3f recovery", recovery_phase, args, report)
    peak = max(peak, torch.cuda.max_memory_allocated())
    # ---- phase 3g: the sharded serving layer, phase 3f's traffic
    more = timed("3g sharded serving", sharded_serving_phase, report, handoff,
                 card)
    for k in kernels:
        k["launches"] += more.get(k["name"], 0)
    del graph
    # ---- phase 3h: the 2D vertex x walker mesh, then the baselines
    more = timed("3h mesh", mesh_phase, report, mesh_h, handoff, starts,
                 stream, card)
    del handoff, mesh_h
    for k in kernels:
        k["launches"] += more.get(k["name"], 0)
    torch.cuda.empty_cache()
    # ---- phase 3i: the LM serving path behind walk-grounded retrieval
    more = timed("3i LM serving", lm_phase, report, card)
    for k in kernels:
        k["launches"] += more.get(k["name"], 0)
    peak = max(peak, torch.cuda.max_memory_allocated())
    torch.cuda.empty_cache()
    # ---- phase 3j: training on a live walk corpus at full width
    more = timed("3j training", train_phase, report, card)
    for k in kernels:
        k["launches"] += more.get(k["name"], 0)
    peak = max(peak, torch.cuda.max_memory_allocated())
    torch.cuda.empty_cache()
    # ---- phase 3k: the walk cells' dry run, held against one rank's share
    # (phase 3l's dry runs run beside its dry runs, done before its timing)
    lm_runs = lm_dryrun_start()
    try:
        more = timed("3k dry run", dryrun_phase, report, card, lm_runs)
        for k in kernels:
            k["launches"] += more.get(k["name"], 0)
        peak = max(peak, torch.cuda.max_memory_allocated())
        torch.cuda.empty_cache()
        # ---- phase 3l: the LM cells' dry run, against one rank's share
        timed("3l LM dry run", lm_dryrun_phase, report, card, lm_runs)
    finally:
        dryrun_stop(lm_runs["runs"]["procs"])
    peak = max(peak, torch.cuda.max_memory_allocated())
    torch.cuda.empty_cache()
    # ---- phase 3m: the LM cells on a real 2 x 2 mesh of four ranks
    more = timed("3m LM mesh", lm_mesh_phase, report, card)
    for k in kernels:
        k["launches"] += more.get(k["name"], 0)
    # ---- phase 3e: attention at full width
    torch.cuda.reset_peak_memory_stats()
    kernels += timed("3e attention", attention_phase, report)
    report["attention_s"] = phase_s["3e attention"]
    print(f"attention phase: {report['attention_s']:.1f} s", flush=True)
    phase_s["total"] = time.perf_counter() - t_start
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in phase_s.items()),
          flush=True)
    report["peak_gib"] = max(peak, torch.cuda.max_memory_allocated()) / 2**30
    if args.report:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1))
    print(f"peak device memory {report['peak_gib']:.1f} GiB", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
