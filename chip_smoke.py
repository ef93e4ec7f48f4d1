#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

  python3 chip_smoke.py

Phases (each one that fails ends the run with a non-zero exit):
  1. environment: torch / CUDA versions, the card's name and power limit;
     TF32 off for matrix products and convolutions.
  2. build: every CUDA source of src/repro_torch/csrc with nvcc.
  3. each kernel and int8 variant against its plain PyTorch version on the
     card, at the main path's shapes, on integer-valued inputs (queries,
     items and codes integer, scales powers of two: every fp32 dot product
     is exact, so ids, scores and flags must be bit-identical, ties
     included) and on float inputs (scores within rtol=1e-5, atol=1e-6; ids
     identical except at near-ties).  ``ms``, ``plain_ms`` and
     ``library_ms`` are device time per call (torch.profiler), beside
     ``bound_ms``, the least time the card could take for the same work;
     ``call_ms`` is the time a caller waits per back-to-back wrapper call
     (CUDA events).  beam_step also runs with a tombstone mask over about
     half the items (its live variants): n_dead must equal the plain
     version's exactly.  quant_score and gather_score are also held bit for
     bit, on every input, to the witness (the previous one-warp-a-row
     kernel of each, launched only here), at their shapes and at their
     edges (SCORER_EDGES: B 1, W 1, a ragged W 33 with a row all -1, d 37
     and d 512), and timed in turns with it.  topk_merge runs at the walk's merge shapes, at
     a throughput cell of 65,536 rows and at the ef-400 pool (C = 416: the
     kernel's rank route), a pure selection: bit-identical on integer and
     float inputs, +-0 pairs and -inf / -1 slots included, each cell beside
     an empty kernel's device time on the same grid (the launch floor);
     flash_attn at granite-3-2b's attention and gemma3-12b's local layer
     (S = T = 4096, and one q_offset case), fp32 within rtol = atol = 2e-5,
     with the fp32 kernel's registers and spills (ptxas) and its FFMAs per
     shared-memory read in the SASS; bf16 within 2**-7 |plain| + 0.04 spread
     of the plain version in bf16 (spread = sqrt(sum p^2 v^2), the size of
     the weighted sum), and within 2**-8 |plain| + 0.015 spread of the plain
     version in fp32 on the same bf16 values, with p's bf16 rounding showing
     (FLASH_TOL); scaled_dot_product_attention as library_ms.  Both kernels
     are also held to those limits at the edges (FLASH_EDGE_SHAPES: ragged S
     and T, hd 32 and 256 with q_offset, rows with no key in their window,
     which must be 0), and mips_topk at its
     own (MIPS_EDGE_SHAPES: a ragged query tile, k = 1 and 32, a depth not a
     multiple of 4), at the full-size loop's ground truth (4,096 queries)
     and past k = 32 (MIPS_WIDE_SHAPES, the select route: k = 33, 100 and
     1,000 at full size, k = N at N = 5,000, each timed with its select
     kernels' sum, library_ms, bound and candidates per row; and
     MIPS_TIED_SHAPES, every score of a query tied, so each row overflows
     its candidate buffer and is selected from its scores).  commit_merge
     runs at the build's merge (M 16 and the angular graph's M 10) and at
     a hierarchy's upper level (M 8); gather_score also at SimpleLSH's
     rerank (W 100 and 800).  commit_merge
     also runs one whole commit (pre-pass and kernel) per cell under
     torch.cuda.set_sync_debug_mode("error"): no read-back from the card.
     A "roofline" line gives each
     redesigned kernel's TFLOP/s, share of its bound and ms over
     library_ms; phase 2 counts the tensor-core instructions of the
     attention kernels' SASS (cuobjdump): the bf16 forward and the bf16 and
     fp32 backwards' dK / dV and dQ kernels must have wgmma (HGMMA) or, the
     fp32 ones at hd 128 and 256, mma.sync (HMMA).  beam_walk, the whole walk in one launch,
     runs in every variant (f32, int8, each with and without a tombstone
     mask) at the main path's walks (WALK_SHAPES; the hierarchy's descent,
     a pool of one, and its upper levels' build walk among them), at pad
     rows born done,
     a max_steps cut, a walk that ends before max_steps (WALK_LONG), an
     ef of 400 whose visited rows stay in device memory (WALK_LARGE_V) and
     a width of 37 (scalar loads), on integer and float inputs: every output (pool, visited, evals, dead
     evals, per-row and global steps) bit-identical to the host loop of the
     beam_step kernel, and to beam_walk_ref on integer inputs (float: the
     tolerance contract); at the search IP walk ``ms`` beside the per-step
     loop's device and call time.  Then the entry points without a system
     caller (topk_merge, flash_attn, the per-step beam_step, mips_topk's
     int8 select route) are driven once: their launches in the kernels
     line are those.
  4. serve default: the port's launch/serve.py one-shot, --index
     ipnsw_plus, at the JAX package's defaults, with --storage f32 and with
     --storage int8; recall@10 within 0.02 of the JAX package's recall for
     the same command; and with --k 33 (mips_topk's select route).  Every
     system path from here on walks with beam_walk and launches no
     per-step beam_step kernel.
  4b. serve default + churn: the serve default's index, built again and
     opened as a MutableIndex (capacity 1.25 N, mutation_batch 32), takes
     the JAX serve CLI's churn trace (turnover 0.2, one hub kill of 8, four
     relink passes of 64), with a search between events; I1-I6 hold, no
     tombstone surfaces (f32 and int8), recall@10 within 0.02 of the JAX
     package's on the same trace and, after relinking to zero debt, at
     least a fresh rebuild's - 0.02.  The first upsert chunk is captured as
     a CUDA graph and every later one replays it, each under
     set_sync_debug_mode("error"); the first int8 search makes the int8
     stores, and the next upsert captures its chunk again over them (123
     replays of 125 chunks).
  4c. serve default through the serving loop: serve --loop (virtual clock),
     with --storage int8 and with --churn-trace 0.2; the batch schedule's
     digest, p50 / p99 / QPS / occupancy / miss fraction (the service
     model's) and the churn events and health equal to the JAX package's,
     recall@10 within 0.02 of it, no steady-state build, no rejection.
     Every dispatch after warmup is a replay of its bucket's CUDA graph
     (16), and under churn every upsert chunk after the first (124 more),
     each under sync debug mode "error".

From phase 4b on, a kernel's launches count each replay of a CUDA graph
that holds it (the wrapper calls made while a graph was captured launch
nothing then, and are not counted): ``count_graph_launches``.
  5. full size: IpNSWPlus and IpNSW at Yahoo!Music's size (136,736 x 300,
     seeded synthetic lognormal items), ground truth from the mips_topk
     kernel; each index searched with the f32 items and the int8 store, and
     the int8 store's quantized scan; build seconds, search time, QPS,
     recall@10, evals, peak memory, graph invariants I1-I4; every search
     again with per-step walks (the host loop of the beam_step kernel, as
     the port walked before beam_walk): every output equal; IpNSW's f32 and
     int8 searches timed both ways in turns; then a profiled IpNSW build,
     f32 search and int8 search, each with per-step walks and with
     beam_walk: device busy time, idle share, walk steps, host time per
     step; and IpNSW's and IpNSWPlus's builds profiled with the host and
     the scan driver (host time per batch; each graph's walk kernel must
     show once a batch in the trace, replayed or not); and IpNSW's search
     of 256 at ef 40 (f32 and int8) as a captured 256 x 40 bucket, its ids
     equal to the search's, profiled.
  5c. scan build driver (build_backend="scan"), inside phase 5: IpNSWPlus
     and IpNSW built again at full size with one insertion batch captured
     as a CUDA graph and replayed over the schedule (266 replays, each
     counted through CUDAGraph.replay and run under
     set_sync_debug_mode("error"), so no sync in the replay loop); every
     graph's adjacency, size, entry and entry_norm bit-identical to the
     host driver's, each search's ids equal; both drivers timed in turns
     (build s; capture ms, host ms per replay and the replay loop's device
     ms by CUDA events).  Phase 4 also serves with --build-backend scan
     (f32 and int8): recall equal to the host driver's run.
  5b. full-size serving loop: an IpNSWPlus at Yahoo!Music's size serves
     4,096 Poisson requests at 2,000 QPS in three deadline classes on the
     ladder (64, 256) x (10, 20, 40), under the wall clock with the f32 and
     the int8 store and under the virtual clock: p50 / p99 latency, QPS,
     occupancy, miss fraction, degraded share, recall@10, steady builds (0),
     peak memory, launches; a request served at the same ef in the wall and
     the virtual run gets the same ids.  Each bucket is one CUDA graph,
     captured at warmup (capture ms a bucket): every dispatch of a run is a
     replay, under sync debug mode "error", and a replay's ids, score bits
     and evals equal the eager program's (the module-level _plus_bucket on
     the same buffers) bit for bit, in every bucket, f32 and int8, with pad
     rows; peak memory with the graphs and with eager dispatches; a
     profiled 256 x 40 dispatch three ways: eager with per-step walks,
     eager, captured.
  5d. observability at full size: IpNSW and IpNSWPlus searched with and
     without a trace context (f32, int8): every output bit-identical, the
     trace's band_hist rows equal to the walk's evals and to a host bincount
     of the visited ids' bands, its ids the visited prefix; a traced ladder
     whose every bucket replay (3 pad rows, sync debug mode "error") equals
     the eager traced program bit for bit, walk columns included; the
     full-size loop under the virtual clock bare, with the metrics registry,
     and with registry and trace (modes interleaved, the min of 3 runs after
     a warm one): metrics_overhead_frac, traced_overhead_frac, the host ms
     a dispatch the recording adds and where it goes, p50 equal in all three,
     no steady build, the served traffic's top-band share; the same loop
     traced under the wall clock beside phase 5b's bare run; serve --loop
     --trace --metrics-out at the serve default (JAX's schedule and recall),
     its JSONL read back and rendered by repro_torch.obs.report; a traced and
     an untraced 256 x 40 dispatch profiled.
  6. full size + churn: a mutable IpNSWPlus at Yahoo!Music's size
     (capacity 170,920) takes a churn trace of turnover 0.1 (427 upsert and
     427 delete batches of 32, one hub kill, four relink passes); ms per
     upsert batch, delete batch and relink pass, search ms with and without
     the tombstone mask on the same index, dead evals per query, recall@10
     before and after the trace and after relinking, health counters, peak
     memory, launches, and one profiled upsert batch eager and captured.
     Every upsert chunk after the first replays its CUDA graph (426
     replays, under sync debug mode "error").  Before the trace, two copies
     of the index (with int8 stores) take the trace's first 64 events, one
     with captured upserts and one eager (``eager_upserts``): both graphs,
     both stores, the live mask, the norms and every entry bit-identical;
     ms per upsert batch both ways.  After it, a bucket ladder over the
     mutable index: a replayed dispatch with the tombstone mask equal to
     the eager program's bit for bit.
  7. sharded (src/repro_torch/core/distributed.py): at full size, P = 4
     shards of 34,184 rows, IpNSW and IpNSWPlus built round-robin and
     norm-banded with the host and the scan driver (the scan driver's
     graphs, one capture a shard, equal the host driver's bit for bit;
     capture ms a shard, build s); f32 and int8: the one-launch fan-out's
     rows equal each shard's own walk (ids, score bits, evals), the
     fan-out's merge the oracle's (sharded_search_reference), the routed
     searches of both drivers and storage="tiered" the exhaustive merge's
     ids up to near-ties and its recall within 0.01, the oracle's visits at
     most the fan-out's, no id >= N; a search launches beam_walk once a
     walk stage (IpNSW 1 unrouted, 2 routed; IpNSWPlus 2 and 4) and reads
     nothing back (sync debug mode "error"); search ms
     of 256 in turns (fan-out, oracle, unsharded IpNSW) and two profiled
     sharded searches; JAX's routing gate logged there and asserted at the
     shard benchmark's CI configuration (N 2,000, d 16, P 8; also logged at
     its full one, N 10,000); under churn at the serve default (N 20,000,
     d 64, the JAX package's banded-churn scenario scaled,
     scripts/sharded_churn_reference.py): I1-I6, every live norm under its
     band's max_norm, no tombstoned gid served, the fan-out's rows equal
     each band's own walk with tombstones (dead evals too), every upsert
     chunk after a band's first a replay under sync debug mode "error",
     recall after relinking within 0.02 of the JAX package's on the same
     scenario, a fresh banded rebuild's beside it; serve --shards 4 with
     norm_bands / upper_bound, with --storage tiered and round-robin, recall
     within 0.02 of the JAX CLI's.  Its launches are added to the kernels
     line.
  8. index family (core/hnsw.py, core/norm_filter.py, core/lsh.py): at full
     size (Yahoo!Music's 136,736 x 300, 256 queries, k 10, ef 40, ground
     truth from mips_topk) a HierarchicalIpNSW (M 16, ef_construction 32,
     insert_batch 512) built with the host and the scan driver: every
     level's adjacency, size, entry, entry_norm, ids and inv bit-identical,
     I1-I4 on every level, the scan's replays under sync debug mode
     "error"; level sizes and build seconds; searched f32 and int8 (recall,
     evals with the descent, ms as the median of 20) with one beam_walk
     launch a level, beside a flat IpNSW at the same ef; after the phase's
     launches are read, every level's walk of both searches equal to the
     per-step loop's.  NormFilteredIndex(keep_frac 0.25, plus) with the
     same knobs, f32 and int8: every id in the kept slice, recall beside
     its bound top_group_share(gt, 25%) and a flat IpNSWPlus's, build s
     and ms.  SimpleLSH(n_bits 96) at T 100 and 800: recall and ms; the
     Hamming stage (mips_topk's select route under bulk ties: every
     agreement an even integer) bit-identical to the plain version on CPU
     copies, its ms, select ms, library ms, bound and candidates per row;
     the card's codes and whole search against the same index copied to
     the CPU (codes equal off SIGN_TOL, ids up to near-ties).  At the
     serve default (N 20,000, d 64) HierarchicalIpNSW's and
     NormFilteredIndex's recall@10 within 0.02 of the JAX package's;
     SimpleLSH's, for plane seeds 0-9, within two result slots of the
     port's own on the CPU seed for seed, and its mean within 0.05 of the
     JAX package's mean (the planes differ;
     scripts/index_family_reference.py).  Its launches (the builds and
     searches; not the timings and comparisons, ``uncounted``) are added
     to the kernels line.  After they are read, a hierarchy on integer
     items (3,000 x 300: levels of 188, 12 and 2 items) built on the card
     with both drivers and on the CPU, bit for bit on every level, and
     its searches equal.
  9. recsys towers and training (src/repro_torch/{train,models,configs}):
     (a) SASRec, MIND, DIEN and DLRM-RM2 at their published configs, every
     RECSYS_SHAPES cell through build_cell on the card: train_batch 3 steps
     (loss, step ms as the mean of steps 2-3, the optimizer's ms against
     its bound of 28 bytes a parameter, peak memory; every step fits the
     card at the published batch of 65,536),
     serve_p99, serve_bulk and retrieval_cand (ms, peak memory, finite and
     sorted outputs); (b) each arch's train, serve and retrieval steps on
     the card against the plain CPU computation at the published widths,
     the tables cut to 100,000 rows and a batch of 256: loss within rtol
     1e-5, every gradient leaf within 1e-4 of its largest element, serve
     and retrieval scores within 1e-5 of their row's largest, retrieval ids
     equal up to near-ties; (c) SASRec's train state through a checkpoint and back, bit
     for bit, and one step resumed from it equal to the uninterrupted
     step; (d) IpNSW+ (scan driver) over SASRec's trained 10^6 x 50 item
     table, searched with 1,024 user embeddings: recall@10 against
     exact_topk rising over ef 40, 80, 160, evals, build s, ms; (e)
     examples/train_and_serve_torch.py at its defaults: the final loss
     within 1e-3 of the port's CPU run and recall@10 within 0.02 of it at
     each ef.  Phase 3 also holds mips_topk's select route at the retrieval
     cells (B 1 at d 50 and 18, B 4 at d 64, N 10^6, k 100; library_ms
     torch.topk(q @ x.T)) and gather_score at the serve cells ((512, 1,000,
     d 50), MIND's (2,048, 1,000, d 64), (262,144, 1,000, d 50)) to their
     plain versions and the witness.  Phase 9's launches (the driven steps,
     the index and the example) are added to the kernels line.
  10. LM family (src/repro_torch/models/{layers,moe,transformer}.py,
     configs): first phase 3's flash_attn checks at the LM path's shapes
     (here, last, as phase 9's): S = 1 edges (small, ragged T, a q_offset
     before the last key; fp32 and bf16) and the cells FLASH_LM_SHAPES
     (granite, gemma global and long_500k, gemma's local ring past its
     wrap, internlm2 and qwen3 decode; granite's 32k prefill, held in row
     blocks), each against the plain version under FLASH_TOL, the ring
     also against JAX's ring mask, timed beside the plain version, SDPA and
     a byte bound.  (a) every LM arch's prefill_32k and decode_32k, and
     gemma's long_500k, through LMArch.build_cell on the card at the
     published widths (bf16, seeded weights drawn on the card), cut by
     LM_CUTS to fit 80 GB (granite's, gemma's and internlm2's prefills
     timed at an eighth of their layers, LM_PREFILL_LAYERS, with the peak
     at full depth logged): ms a prefill, tokens/s, ms a decode step on
     caches of seeded draws (4 steps at q_offset seq - 4 ... seq - 1, each
     under sync debug mode "error"), peak memory, finite logits, and where
     one decode step's device time goes; (b) each arch at the published
     widths, one pattern cycle of layers, fp32, batch 2, a 256-token
     prompt and 5 decode steps, on the card against the CPU: logits within
     1e-4 of the row's largest |logit|, argmax and MoE expert choices equal
     but at near-ties; (c) examples/lm_decode_torch.py on the card, its
     tokens equal to its CPU run's.  Every prefill and decode of an LM
     layer is one flash_attn launch: the launches of (a) and (c) must equal
     the layer calls made, and are added to the kernels line.
  11. LM training (src/repro_torch/csrc/flash_attn_bwd.cu, models,
     train/optimizer.py adamw_update_, configs train_4k, launch/train.py):
     (a) the flash_attn backward (its delta, dK / dV and dQ kernels) against
     flash_attention_bwd_ref on the same inputs (q, k, v, the forward
     kernel's fp32 output -- bf16: the residual it writes beside its bf16
     output -- and lse, a seeded dout) at its edges (FLASH_BWD_EDGES:
     ragged S, hd 32 and 256, G 1, a window of 17, a q_offset, rows with no
     key, whose gradients must be 0, and the last three again at hd 256;
     fp32 and bf16) and at each train cell's attention (FLASH_BWD_CELLS at
     LM_TRAIN_CUTS' batch: granite, gemma local and global, internlm2,
     qwen3; bf16, granite, internlm2 and gemma global also fp32) within
     FLASH_BWD_TOL, the forward's lse within LSE_ATOL of the plain
     version's on fp32 values, two runs
     bit-identical; each cell timed beside its plain version, SDPA's
     backward and a bound of 10 hd flops a pair (fp32: 3 x 10 hd on the
     tensor cores in 3xTF32, with the fp32-unit bound beside); (b) every train_4k cell through LMArch.build_cell at the
     published widths cut by LM_TRAIN_CUTS (bf16, seeded weights drawn on
     the card): LM_TRAIN_STEPS steps (ms a step as the mean of steps 2-3,
     tokens/s, model-flops share of 989 TFLOP/s, peak memory, the batch
     that fits, losses finite; the last step under sync debug mode
     "error"; the first step, outside the mean, profiled for its device
     time by flash_attn forward / backward / GEMMs / rest), then the gradient norm (finite; float64
     sums, the optimizer's fp32 norm, JAX's formula, logged beside) by a
     value_and_grad of its own; grok's cell builds and, 73.0 GiB of state
     at 12 bytes a parameter, is not stepped; (c) each arch at the
     published widths, one pattern cycle (LM_TRAIN_CPU_LAYERS), fp32, batch
     1, 256 tokens, loss_chunk 128, on the card against the CPU: each
     block's VJP on the CPU run's block input and output cotangent within
     LM_BLOCK_GRAD_RTOL of a leaf's largest, the head (final norm and
     cross-entropy) on the CPU's last hidden state (loss within
     LM_LOSS_RTOL, gradients within LM_HEAD_GRAD_RTOL), the limits set from
     scripts/lm_grad_conditioning.py (whose block, head and routing
     helpers this phase uses); the free run's loss and gradients logged (a
     random model at these widths is chaotic in fp32); the bf16 head
     product and its VJP (train_4k's loss on the card) against the CPU
     within HEAD_BF16_TOL;
     (d) the train launcher's LM branch on the card (fp32) against its CPU
     run, each loss within LM_LAUNCHER_RTOL.  Every layer call that needs
     a gradient is one backward launch, and under remat two forward
     launches ((b): bf16) or one without ((d): fp32): the launches of (b)
     and (d) must equal those calls; they and (c)'s fp32 launches (its
     block VJPs and free run) are added to the kernels line.
  12. GNN (src/repro_torch/models/{gnn,sampler}.py, configs GNNArch,
     launch/train.py's GNN branch): MeshGraphNet at the published widths
     (15 layers, d_hidden 128, fp32), graphs from seeds: (a) the four cells
     through GNNArch.build_cell, GNN_TRAIN_STEPS steps each (the last under
     sync debug mode "error"; ms a step, edges/s, model flops over 67
     TFLOP/s, peak memory, the losses finite), the first step profiled for
     its device time by matrix products / index ops / the rest; ogb_products
     cut by GNN_TRAIN_CUTS (nodes and edges by one factor), minibatch_lg
     fed by the fanout sampler; (b) ogb_products' forward uncut (61,859,140
     edges) by forward_chunked: ms beside its flop bound, peak memory,
     outputs finite; (c) full_graph_sm whole on the card against the CPU:
     output, loss and every gradient leaf within GNN_OUT_RTOL,
     GNN_LOSS_RTOL and GNN_GRAD_RTOL (scripts/gnn_grad_conditioning.py);
     (d) the train launcher's GNN branch on the card against its CPU run,
     and each cut at step 2 and resumed, every loss within
     LM_LAUNCHER_RTOL.  No TPU kernel is on this path (message passing is
     index_add_): the phase launches no hand-written kernel.
  13. mesh tools (src/repro_torch/launch/mesh.py, train/compress.py, the
     sharded GNN layer, the MoE expert-parallel dispatch, the shard-local
     retrieval, the cells' mesh branches): one process group of one rank
     (NCCL for the card, gloo for host tensors, a FileStore under build/)
     and make_host_mesh() on "cuda".  A one-rank mesh takes the entry points'
     local branches, as JAX's do, so the collective bodies are called
     directly on the group and held to the local path: (a) MeshGraphNet's
     sharded layers on full_graph_sm whole at the published widths, forward
     and gradient (GNN_OUT_RTOL, GNN_LOSS_RTOL, GNN_GRAD_RTOL); (b)
     expert_parallel at qwen3's MoE widths, MESH_MOE_TOKENS tokens, fp32
     (LM_BLOCK_RTOL) and bf16 (MESH_MOE_BF16_ULPS bf16 ulps of a row's
     largest), aux bit-equal; (c) the int8 error-feedback all-reduce over
     one granite layer's gradient shapes, bit-equal to the same call on
     host copies, ms beside its byte bound; (d) sharded_topk at SASRec's
     and MIND's retrieval_cand, ids equal to the unsharded cell's up to
     near-ties, mips_topk's select route launched; (e) granite's train_4k
     through build_cell(..., mesh=) (MESH_TRAIN: 2 layers, B 2, bf16) on a
     one-rank mesh named (data, model), JAX's layouts (pure FSDP: every
     weight held as its specs() shard, gathered a layer at a time): the
     loss equal to the cell's without a mesh, every gradient leaf but the
     embedding's bit-equal, one step from drawn AdamW moments at
     MESH_LM_STEP (past the warmup) with the loss bit-equal and the new
     parameters, mu and nu within MESH_LM_STEP_RTOL of a leaf's largest
     (the embedding's bf16 atomics reach the clip's norm),
     flash_attn_bf16 and its backward launched; (f)
     examples/quickstart_torch.py, norm_bias_analysis_torch.py and
     distributed_serving_torch.py at their defaults, tables printed,
     quickstart launching beam_walk, commit_merge and mips_topk; (g) every
     recsys train and serve cell and DLRM's retrieval_cand at the published
     widths through build_cell(..., mesh=make_host_mesh()) (row-sharded
     tables: a masked gather and an all-reduce a lookup), batches cut by
     MESH_RECSYS_BATCH, against the same cell without a mesh: the loss
     bit-equal, each parameter and AdamW moment after a step from drawn
     moments at step RECSYS_MIDWAY_STEP within RECSYS_GRAD_RTOL of its
     leaf's largest, serve outputs within RECSYS_SCORE_RTOL, retrieval
     ids equal but at near-ties; (h) the LM serve cells on the (data,
     model) mesh with JAX's layouts (Megatron over "model", the caches'
     sequence over "model": a slice attention with the row lse and the
     slices' combine): granite's prefill_32k and decode_32k and gemma's
     decode_32k at MESH_LM_SERVE's cuts, logits and caches bit-equal to the
     cells without a mesh; (i) the slice attention and the combine on one
     card over MESH_SLICES' slices of granite's decode_32k cache (16) and
     gemma's long_500k global cache (256), at a position that leaves slices
     empty and at the last, against the whole-cache flash_attn decode
     within FLASH_TOL's bf16 limit, launches and ms logged.  The launches of
     (d)-(i) are added to the kernels line.
  14. dry-run (src/repro_torch/launch/{dryrun,roofline}.py): DRYRUN_CELLS
     (SASRec's serve_p99 on both production meshes, granite's train_4k on
     the single pod) traced as rank 0 of a fake process group of 256 / 512
     ranks in a subprocess with CUDA_VISIBLE_DEVICES="", and priced by the
     roofline's model of an H100 SXM (each row logged: modelled figures,
     not measurements); then the memory model: the dry-run's peak of
     SASRec's serve_p99 and of phase 11's granite cut without a mesh (meta
     tensors) against the card's max_memory_allocated on the same cells,
     within MEMORY_MODEL_RTOL.  It launches no kernel.
Each phase logs its seconds.  The line before the last is the JSON list
of kernels; the last line is the JSON result the run is read by.
"""
from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# `PYTHONPATH=src python -m repro.launch.serve` (the JAX package, on the CPU)
# printed: [serve] index=ipnsw_plus shards=1 storage=f32 N=20000 B=256 ef=40:
# recall@10=0.933 evals/q=540 (0.74 ms/query batch-amortized) xla_compiles=891
JAX_SERVE_RECALL = 0.933
# `PYTHONPATH=src python -m repro.launch.serve --storage int8` (CPU) printed:
# [serve] index=ipnsw_plus shards=1 storage=int8 N=20000 B=256 ef=40:
# recall@10=0.935 evals/q=540 (0.44 ms/query batch-amortized) xla_compiles=970
JAX_SERVE_RECALL_INT8 = 0.935
# `PYTHONPATH=src python scripts/churn_reference.py` (the JAX package, on the
# CPU) printed: recall@10 before=0.9332 after_trace=0.9258 after_relink=0.9258
# after_relink_int8=0.9262 fresh_rebuild=0.9352 (the trace left no relink debt)
JAX_CHURN_RECALL = 0.9258
RECALL_MARGIN = 0.02
# `PYTHONPATH=src python -m repro.launch.serve --loop [--storage int8 |
# --churn-trace 0.2]` (the JAX package, on the CPU) printed for f32:
# [serve --loop] index=ipnsw_plus storage=f32 clock=virtual N=20000 rate=2000qps
# requests=256 ladder=64x10/64x20/64x40/256x10/256x20/256x40: recall@10=0.933
# p50=7.73ms p99=12.47ms qps=2051 occupancy=0.25 miss_frac=0.000
# recompiles(warmup/steady)=6/0 xla_compiles=1587
# and, with the churn trace, `churn: events=255 rejected=0 live_frac=1.000
# dead_edge_frac=0.000 relink_debt=0`.  The unrounded values and the digest of
# the batch schedule come from `PYTHONPATH=src python
# tools/serve_loop_reference.py [--storage int8 | --churn-trace 0.2]` (the same
# runs).  Under the virtual clock the schedule and the latencies are the
# LinearServiceModel's, a pure function of the trace: the port must print
# them exactly; recall@10 is the index's (the churn run's ground truth is the
# catalog before the churn, as in the JAX CLI).
JAX_LOOP_RECALL = {"f32": 0.9332031250000001, "int8": 0.934765625, "churn": 0.776953125}
JAX_LOOP_SUMMARY = {"p50_ms": 7.728291443464242, "p99_ms": 12.474367708361871,
                    "qps": 2051.2348791342347, "occupancy": 0.25, "deadline_miss_frac": 0.0,
                    "served": 256, "batches": 16, "recompiles_warmup": 6,
                    "recompiles_steady": 0, "rejected": 0}
JAX_LOOP_SCHEDULE_SHA256 = "b9a4f4e5473c23af7c4c8d147eaf15d81cb08e58293bc6c52540013b47aece78"
JAX_LOOP_CHURN = {"mutation_events": 255, "health_live_fraction": 1.000,
                  "health_dead_edge_frac": 0.000, "health_relink_debt": 0.0}  # as printed

PROFILER_SESSIONS = 8      # sessions device_ms tries before it gives up
# the H100 SXM's rates, the dry-run's roofline model (stdlib only: no torch at import)
from repro_torch.launch.roofline import HBM_BW as HBM_BYTES_PER_S, PEAK_FLOPS  # noqa: E402

FP32_FLOP_PER_S = PEAK_FLOPS["fp32"]  # outside the tensor cores
BF16_FLOP_PER_S = PEAK_FLOPS["bf16"]  # dense, on the tensor cores
TF32_FLOP_PER_S = PEAK_FLOPS["tf32"]  # dense, on the tensor cores

N_FULL, D_FULL = 136_736, 300  # Yahoo!Music (paper §5 dataset table)
# the full-size loop: 4,096 queries at 2,000 QPS on _build_ladder(256, 40)
LOOP_FULL_REQUESTS, LOOP_FULL_RATE = 4096, 2000.0
BEAM_SHAPES = {  # walk: (B, L, M, S, V) on the main path, d = 300
    "build_angular": (512, 10, 10, 1, 201),
    "build_ip": (512, 32, 16, 161, 1185),
    "search_angular": (256, 10, 10, 1, 201),
    "search_ip": (256, 40, 16, 160, 1440),
}
# beam_walk: (B, L, M, S, max_steps) of the main path's walks, d = 300; V = S +
# max_steps * M (ef 40 on ip-NSW+: 160 + 80 * 16 = 1,440 visited ids)
WALK_SHAPES = {
    "build_angular": (512, 10, 10, 1, 20),
    "build_ip": (512, 32, 16, 161, 64),
    "search_angular": (256, 10, 10, 1, 20),
    "search_ip": (256, 40, 16, 160, 80),
    # HierarchicalIpNSW (core/hnsw.py) at full size: the greedy descent, a pool
    # of one on an upper level (M 8, 4 * 16 steps), and an upper level's build
    # walk (M 8, ef_construction 8, 16 steps)
    "descent": (256, 1, 8, 1, 64),
    "build_upper": (512, 8, 8, 1, 16),
}
# on a random graph new candidates keep entering the pool, so these walks run
# to max_steps; with 400 steps the search IP walk ends on its own
WALK_LONG = (256, 40, 16, 160, 400)
# ef 400: V = 160 + 800 * 16 = 12,960 ids, past VISITED_SHARED_MAX, so the
# walk scans its visited rows in device memory
WALK_LARGE_V = (64, 400, 16, 160, 800)
# (insert batch, M); "upper": a HierarchicalIpNSW upper level (M 16 // 2)
COMMIT_SHAPES = {"ip": (512, 16), "angular": (512, 10), "upper": (512, 8)}
# gathered scorers: (B, W) on the main path, d = 300
QUANT_SHAPES = {"seed_ip": (256, 160), "seed_angular": (256, 1)}
GATHER_SHAPES = {"seed_ip": (256, 160), "build_seed_ip": (512, 161), "rerank_ip": (256, 40),
                 "rerank_angular": (256, 10), "build_seed_angular": (512, 1),
                 # SimpleLSH's exact rerank of its T candidates (phase 8)
                 "lsh_rerank_t100": (256, 100), "lsh_rerank_t800": (256, 800)}
# the scorers' edges, checked only: (B, W, d, row 0 all -1) -- one query, one
# slot a query, a ragged last tile with a dead row, the scalar loads (d 37)
# and two rounds of loads (d 512)
SCORER_EDGES = {"b1": (1, 160, D_FULL, False), "w1": (256, 1, D_FULL, False),
                "w33_dead_row": (256, 33, D_FULL, True), "d37": (256, 160, 37, False),
                "d512": (64, 160, 512, True)}
MIPS_SHAPES = {"full": (256, N_FULL, D_FULL, 10), "serve_default": (256, 20_000, 64, 10),
               # the full-size loop's ground truth: 4,096 queries in one call
               "loop_ground_truth": (LOOP_FULL_REQUESTS, N_FULL, D_FULL, 10)}
# mips_topk's edges, checked only: a ragged query tile with k = 1 and with the
# largest k, and a depth that is not a multiple of 4 (the scalar loads)
MIPS_EDGE_SHAPES = {"b100_k1": (100, 20_000, 64, 1), "b100_k32": (100, 20_000, D_FULL, 32),
                    "b100_d37": (100, 5_000, 37, 10)}
# the select route (k > 32) at full size, and k = N at a small N
MIPS_WIDE_SHAPES = {"full_k33": (256, N_FULL, D_FULL, 33), "full_k100": (256, N_FULL, D_FULL, 100),
                    "full_k1000": (256, N_FULL, D_FULL, 1000),
                    "n5000_kN": (100, 5_000, 64, 5_000)}
# the select route where one bin holds every key (all scores of a query tie):
# each row overflows its candidate buffer and is selected from its scores
MIPS_TIED_SHAPES = {"tied_k33": (64, N_FULL, 64, 33)}
# topk_merge at the walk's merge shapes: (B, L, M)
MERGE_SHAPES = {"search_ip": (256, 40, 16), "build_ip": (512, 32, 16),
                "search_angular": (256, 10, 10)}
# topk_merge past the walk's batches: a throughput cell (75.5 MB moved) and
# the ef-400 pool, whose C = 416 takes the kernel's rank route (C > 64)
MERGE_WIDE_SHAPES = {"throughput": (65_536, 40, 16), "ef400_pool": (256, 400, 16)}
# flash_attn at two model widths (src/repro/configs/granite_3_2b.py, the local
# layer of gemma3_12b.py): (B, S, T, H, KV, hd, q_offset, window)
FLASH_SHAPES = {"granite_3_2b": (1, 4096, 4096, 32, 8, 64, 0, None),
                "granite_3_2b_offset": (1, 2048, 4096, 32, 8, 64, 2048, None),
                "gemma3_12b_local": (1, 4096, 4096, 16, 8, 256, 0, 1024)}
# the kernels' edges (tiles past the end, q_offset, hd 32 / 256, rows with no
# key, which must be 0), checked only, fp32 and bf16, under the limits below
FLASH_EDGE_SHAPES = {"ragged_gqa": (2, 1000, 1000, 4, 2, 128, 0, None),
                     "hd32_offset": (1, 300, 700, 4, 2, 32, 400, None),
                     "hd256_offset_window": (1, 300, 700, 4, 2, 256, 400, 100),
                     "fully_masked": (1, 64, 64, 2, 1, 64, 100, 8)}
# flash_attn: |out - plain| <= atol + rtol * |plain| + c * spread, where spread =
# sqrt(sum_t p_t^2 v_t^2) is the size of the weighted sum each output is (a
# relative error e in every weight p_t moves it by about e * spread).  The
# bf16 limits come from the readings phase 3 logs (largest error by |out| bin
# and by row, beside rtol * |out| and over the spread; PERF.md, PR 14).
FLASH_TOL = {"float32": (2e-5, 2e-5, 0.0),   # (rtol, atol, c): the JAX tests' fp32 limit
             "bfloat16": (2**-7, 0.0, 0.04)}  # one ulp of the output's rounding, and the
#   plain version's own rounding of q.k to bf16 before its softmax (largest
#   excess 0.022 spread)
# bf16 held a second time, against the plain version in fp32 on the same bf16
# values: half an ulp for the output's rounding, and the rounding of p to bf16
# (kernel.py:69; largest excess 0.008 spread), which must show somewhere
FLASH_BF16_VS_FP32 = (2**-8, 0.0, 0.015)
FLASH_P_ROUNDED = 1e-4  # least largest excess over the spread: p was rounded to bf16
# the JAX serve CLI's churn deployment (src/repro/launch/serve.py:309-321)
CHURN = dict(batch=32, seed=3, profile="lognormal", duration_s=1.0, hub_kill_at=0.5,
             hub_kill_k=8, relink_every=0.25, relink_budget=64)
RELINK_PASS_CAP = 64  # full size: relink passes after the trace, at most


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` as its caller sees them, by CUDA
    events around back-to-back calls: where the host enqueues slower than
    the card runs, this is host time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20, only: str = "", once: bool = False) -> float:
    """Mean device milliseconds per call of ``fn``: the time its kernels
    (those whose name contains ``only``) ran on the card, from
    torch.profiler's device-side events; host gaps are not counted.
    ``once``: ``fn`` launches the one kernel named by ``only`` once a call,
    so its mean over the launches a session recorded is the time a call
    (a session may drop a launch's event)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # A session can come back without device events, or with some of them
    # lost: every kernel that carries a twentieth of the time runs on each
    # call, so each must show at least ``reps`` launches.  (A plain version
    # may launch a small kernel on some calls only: the library's choice.)
    for attempt in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and only in e.key
                   and e.self_device_time_total > 0]
        total = sum(e.self_device_time_total for e in kernels)
        if once and len(kernels) == 1 and kernels[0].count >= reps // 2:
            return total / kernels[0].count / 1e3
        fewest = min((e for e in kernels if e.self_device_time_total >= total / 20),
                     key=lambda e: e.count, default=None)
        if fewest is not None and fewest.count >= reps:
            return total / reps / 1e3
        log(f"profiler session {attempt + 1} saw {0 if fewest is None else fewest.count} of "
            f"{reps} launches of {'no kernel' if fewest is None else fewest.key[:80]}; "
            f"measuring again")
    raise RuntimeError(f"the profiler lost device events in {PROFILER_SESSIONS} sessions")


def warm_up_profiler() -> None:
    """Throwaway profiler sessions until one sees every launch: the first
    sessions of a process can miss the card's events while the tracer
    starts up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 20, device="cuda")
    for _ in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                x = x * 1.0
            torch.cuda.synchronize()
        seen = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
        if seen >= 10:
            return


def bound(nbytes: float, flops: float, flop_rate: float = FP32_FLOP_PER_S):
    """(ms, what bounds it): the larger of bytes over the memory rate and
    flops over ``flop_rate`` (the fp32 rate unless named)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------- phases


def phase_env() -> str:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    print(card, flush=True)
    return card


def phase_build() -> None:
    from repro_torch.kernels import _lib

    t0 = time.perf_counter()
    path = _lib.build()
    _lib.lib()
    log(f"built {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in _lib.build_log().splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            log(f"ptxas {line.strip()}")
    log_kernel_sass(path)


def ptxas_usage(name: str) -> dict:
    """Registers and spill bytes of the kernels whose mangled name contains
    ``name``, from the build's ptxas output: {mangled name: (registers,
    spill stores, spill loads)}."""
    import re

    from repro_torch.kernels import _lib

    usage, entry, spills = {}, None, (0, 0)
    for line in _lib.build_log().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            spills = (int(m.group(1)), int(m.group(2)))
        elif entry and (m := re.search(r"Used (\d+) registers", line)):
            if name in entry:
                usage[entry] = (int(m.group(1)), *spills)
            entry, spills = None, (0, 0)
    return usage


# SASS opcodes counted in the attention kernels: the tensor-core products of
# the bf16 kernels (HGMMA: wgmma, HMMA: mma.sync), the forward and the
# backward's dK / dV and dQ kernels (tc::dkv_kernel, tc::dq_kernel, by their
# mangled names), and of the fp32 backward's 3xTF32 kernels (x3::dkv_kernel,
# x3::dq_kernel on wgmma; x3m::dkv_kernel, x3m::dq_kernel on mma.sync, hd
# 128 and 256); the fp32 forward's FMAs and shared-memory traffic (LDS.128:
# float4 reads)
TC_KERNELS = ("flash_attn_bf16_kernel", "2tc10dkv_kernel", "2tc9dq_kernel", "2x310dkv_kernel",
              "2x39dq_kernel", "3x3m10dkv_kernel", "3x3m9dq_kernel")
SASS_OPS = {**{k: ("HGMMA", "HMMA") for k in TC_KERNELS},
            "flash_attn_f32_kernel": ("FFMA", "LDS.128", "LDS", "STS.128", "STS", "SHFL",
                                      "MUFU.EX2")}


def _is_op(word: str, op: str) -> bool:
    """``word`` is the opcode ``op`` with any modifiers; "LDS" / "STS" are the
    shared-memory accesses that are not 128-bit, "LDS.128" / "STS.128" those
    that are."""
    base, wide = op.split(".")[0], op.endswith(".128")
    if base in ("LDS", "STS"):
        return (word == base or word.startswith(base + ".")) and word.endswith(".128") == wide
    return word == op or word.startswith(op + ".")


def log_kernel_sass(library: Path) -> None:
    """Counts SASS_OPS in the attention kernels' SASS (static counts: the
    unrolled loop bodies), by cuobjdump where the toolkit has it.  The bf16
    kernels (TC_KERNELS) must have tensor-core instructions; for the fp32
    kernel the FFMAs per shared-memory read instruction are logged."""
    import shutil

    from repro_torch.kernels import _lib

    tool = shutil.which("cuobjdump") or str(Path(_lib.nvcc()).parent / "cuobjdump")
    if not Path(tool).exists():
        log("cuobjdump not found: the attention kernels' SASS not counted")
        return
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, name, ops = {}, None, ()
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            ops = next((o for k, o in SASS_OPS.items() if k in name), ())
        elif ops:
            c = counts.setdefault(name, dict.fromkeys(ops, 0))
            words = line.replace(";", " ").split()
            for op in ops:
                c[op] += any(_is_op(w, op) for w in words)
    for fn, c in counts.items():
        line = " ".join(f"{op}={n}" for op, n in c.items())
        if "FFMA" in c:
            line += f" ffma_per_lds={c['FFMA'] / max(c['LDS.128'] + c['LDS'], 1):.2f}"
        log(f"sass {fn}: {line}")
        if "HGMMA" in c:
            assert c["HGMMA"] + c["HMMA"] > 0, f"{fn} has no tensor-core instruction"
    for k in TC_KERNELS:
        assert any(k in fn for fn in counts), f"no {k} in the library's SASS"


def _int_or_float(shape, integer: bool, g):
    import torch

    if integer:
        return torch.randint(-3, 4, shape, generator=g, device="cuda").float()
    return torch.randn(shape, generator=g, device="cuda") / shape[-1] ** 0.5


def _int8_store(items, integer: bool, g):
    """(codes, scales) of the int8 store: for integer items, small integer
    codes and power-of-two scales (every quantized score exact); for float
    items, the port's quantizer."""
    import torch

    from repro_torch.core.storage import quantize_items

    if not integer:
        return tuple(quantize_items(items))
    n, d = items.shape
    codes = torch.randint(-3, 4, (n, d), generator=g, device=items.device).to(torch.int8)
    exps = torch.randint(-3, 4, (n,), generator=g, device=items.device).float()
    return codes, torch.pow(2.0, exps)


def _plain_scorer(scales):
    """The plain scorer of one store: the fp32 dot, or quant_score_ref."""
    from repro_torch.core.similarity import gather_scores
    from repro_torch.kernels.quant_score import quant_score_ref

    if scales is None:
        return gather_scores
    return lambda q, codes, ids: quant_score_ref(q, codes, scales, ids)


def _beam_state(shape, rows, scales, integer: bool, g):
    """A valid walk state at ``shape`` over ``rows`` (fp32 items, or int8
    codes with ``scales``): pools sorted by the plain scorer, empty tail
    slots, checked slots, rows done on input and rows with nothing left
    unchecked, visited buffers that hit the adjacency rows."""
    import torch

    from repro_torch.core.similarity import top_l

    b, l, m, _, v = shape
    n, d = rows.shape
    dev = rows.device
    queries = _int_or_float((b, d), integer, g)
    adj = torch.randint(0, n, (n, m), generator=g, device=dev, dtype=torch.int32)
    adj[torch.rand((n, m), generator=g, device=dev) < 0.1] = -1
    ids = torch.randint(0, n, (b, l), generator=g, device=dev, dtype=torch.int32)
    n_empty = torch.randint(0, l // 2 + 1, (b, 1), generator=g, device=dev)
    ids[torch.arange(l, device=dev) >= l - n_empty] = -1
    scores = torch.where(ids >= 0, _plain_scorer(scales)(queries, rows, ids), float("-inf"))
    scores, order = top_l(scores, l)
    ids = ids.gather(1, order)
    checked = (torch.rand((b, l), generator=g, device=dev) < 0.5) | (ids < 0)
    checked[: b // 16] = True
    done = torch.rand(b, generator=g, device=dev) < 0.1
    visited = torch.randint(0, n, (b, v), generator=g, device=dev, dtype=torch.int32)
    visited[torch.rand((b, v), generator=g, device=dev) < 0.3] = -1
    # every pool id was scored, so it is in the visited buffer, as in a walk
    hits = adj[ids.clamp_min(0).long()][:, :, : m // 2].reshape(b, -1)
    h = min(v // 2 - l, hits.shape[1])
    visited[:, :l] = ids
    visited[:, l: l + h] = hits[:, :h]
    return (ids, scores.contiguous(), checked.contiguous(), visited, done, queries, adj, rows)


def _check_topk(name, ids_k, s_k, ids_p, s_p, integer: bool) -> int:
    """Integer inputs: bit-identical.  Float inputs: the tolerance contract;
    returns the rows that needed the near-tie exception."""
    import torch

    from repro_torch.testing import assert_topk_match

    if integer:
        assert torch.equal(ids_k, ids_p), f"{name}: ids differ on integer inputs"
        assert torch.equal(s_k, s_p), f"{name}: scores differ on integer inputs"
        return 0
    return len(assert_topk_match(ids_k.cpu().numpy(), s_k.cpu().numpy(),
                                 ids_p.cpu().numpy(), s_p.cpu().numpy()))


def _max_abs_err(a, b) -> float:
    import torch

    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def phase_beam_step(items_by_kind, stores_by_kind, g) -> dict:
    """beam_step over the fp32 items and over the int8 store, each without
    and with a tombstone mask (about half the items dead); returns the
    timings of the four variants at the search IP shape, float inputs."""
    import torch

    from repro_torch.kernels.beam_step import beam_step, beam_step_ref

    out = {}
    counters = {"f32": "launches", "int8": "launches_int8", "f32_live": "launches_live",
                "int8_live": "launches_int8_live"}
    for variant in ("f32", "int8"):
        for walk, shape in BEAM_SHAPES.items():
            for kind, items in items_by_kind.items():
                rows, scales = (items, None) if variant == "f32" else stores_by_kind[kind]
                args = _beam_state(shape, rows, scales, kind == "int", g)
                live = torch.rand(rows.shape[0], generator=g, device=rows.device) >= 0.5
                for mask in (None, live):
                    tag = variant if mask is None else f"{variant}_live"
                    run = lambda: beam_step(*args, scales, mask)  # noqa: E731
                    plain = lambda: beam_step_ref(  # noqa: E731
                        *args, score_fn=_plain_scorer(scales), live=mask)
                    k, p = run(), plain()
                    torch.cuda.synchronize()
                    name = f"beam_step[{tag}] {walk}/{kind}"
                    assert torch.equal(k.nbr_ids, p.nbr_ids), f"{name}: nbr_ids"
                    assert torch.equal(k.done, p.done), f"{name}: done"
                    assert torch.equal(k.n_scored, p.n_scored), f"{name}: n_scored"
                    if mask is None:
                        assert k.n_dead is None and p.n_dead is None, f"{name}: n_dead"
                    else:
                        assert torch.equal(k.n_dead, p.n_dead), f"{name}: n_dead"
                        assert int(k.n_dead.sum()) > 0, f"{name}: no tombstone was scored"
                    rows_tied = _check_topk(name, k.pool_ids, k.pool_scores, p.pool_ids,
                                            p.pool_scores, kind == "int")
                    if kind == "int":
                        assert torch.equal(k.pool_checked, p.pool_checked), f"{name}: checked"
                    err = _max_abs_err(k.pool_scores, p.pool_scores)
                    ms = device_ms(run)
                    plain_ms = device_ms(plain)
                    call_ms = cuda_ms(run)
                    b, l, m, _, v = shape
                    d = items.shape[1]
                    row_bytes = d * 4 if variant == "f32" else d + 4  # codes + scale
                    n_upd, n_scored = int((~k.done).sum()), int(k.n_scored.sum())
                    nbytes = (b * l * 9 + b + n_upd * (v * 4 + d * 4 + m * 4)
                              + n_scored * row_bytes + b * l * 9 + b * m * 4 + b * 5)
                    if mask is not None:
                        nbytes += n_scored + b * 4  # a live byte per valid neighbour, n_dead
                    bound_ms, by = bound(nbytes, 2.0 * d * n_scored)
                    launches = getattr(beam_step, counters[tag])
                    log(f"kernel=beam_step variant={tag} walk={walk} inputs={kind} B={b} "
                        f"L={l} M={m} V={v} d={d} ms={ms:.4f} call_ms={call_ms:.4f} "
                        f"plain_ms={plain_ms:.4f} library_ms=None bound_ms={bound_ms:.5f} "
                        f"bound_by={by} near_tie_rows={rows_tied} max_abs_err={err:.3g} "
                        f"n_dead={0 if k.n_dead is None else int(k.n_dead.sum())} "
                        f"launches={launches}")
                    if walk == "search_ip" and kind == "float":
                        out[tag] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                        bound_by=by, library_ms=None, max_abs_err=err)
    return out


def _walk_inputs(shape, rows, scales, integer: bool, live, g, *, pad_rows: bool = False):
    """A walk's seeded state as core/search.beam_search makes it, over a
    random graph (10% empty slots) of the ``rows`` store: deduplicated
    seeds (10% -1), the seed pool sorted by the plain scorer, visited with
    the seeds then -1, about 10% of the rows born done (``pad_rows``: a
    third are pad rows, seedless and done), seed evals and dead evals.
    Returns (args, kwargs) of beam_walk, with ``max_steps``."""
    import torch

    from repro_torch.core.search import _dedup_ids
    from repro_torch.core.similarity import top_l

    b, l, m, s, max_steps = shape
    n, d = rows.shape
    dev = rows.device
    queries = _int_or_float((b, d), integer, g)
    adj = torch.randint(0, n, (n, m), generator=g, device=dev, dtype=torch.int32)
    adj[torch.rand((n, m), generator=g, device=dev) < 0.1] = -1
    seeds = torch.randint(0, n, (b, s), generator=g, device=dev, dtype=torch.int32)
    seeds[torch.rand((b, s), generator=g, device=dev) < 0.1] = -1
    done = torch.rand(b, generator=g, device=dev) < 0.1
    if pad_rows:
        done = torch.arange(b, device=dev) % 3 == 1
        seeds[done] = -1
    seeds = _dedup_ids(seeds)
    ok = seeds >= 0
    scores = torch.where(ok, _plain_scorer(scales)(queries, rows, seeds), float("-inf"))
    top, idx = top_l(scores, min(l, s))
    pool_ids = torch.full((b, l), -1, dtype=torch.int32, device=dev)
    pool_scores = torch.full((b, l), float("-inf"), device=dev)
    pool_ids[:, : idx.shape[1]] = seeds.gather(1, idx)
    pool_scores[:, : idx.shape[1]] = top
    visited = torch.full((b, s + max_steps * m), -1, dtype=torch.int32, device=dev)
    visited[:, :s] = seeds
    evals = ok.sum(-1, dtype=torch.int32)
    dead = None if live is None else (ok & ~live[seeds.clamp_min(0).long()]).sum(
        -1, dtype=torch.int32)
    args = (pool_ids, pool_scores, pool_ids < 0, visited, done, evals, queries, adj, rows,
            scales, live, dead)
    return args, dict(max_steps=max_steps)


def _fresh(args):
    """The walk's arguments with a fresh visited buffer (a walk writes its
    visited in place)."""
    return (*args[:3], args[3].clone(), *args[4:])


def per_step_walk(pool_ids, pool_scores, pool_checked, visited, done, evals, queries, adj,
                  items, scales=None, live=None, dead_evals=None, *, max_steps,
                  capturable=False):
    """The yardstick: beam_walk as a host loop of the beam_step kernel (one
    launch and one done.all() read a step), the walk the port ran before
    beam_walk.  Same arguments and result; it reads back every step, so a
    capturable walk cannot take it."""
    from repro_torch.kernels.beam_step import beam_step, host_walk

    if capturable:
        raise ValueError("the per-step loop reads back every step: it cannot be captured")

    def step(ids, scores, checked, vis, dn):
        return beam_step(ids, scores, checked, vis, dn, queries, adj, items, scales, live)

    return host_walk(step, pool_ids, pool_scores, pool_checked, visited, done, evals,
                     dead_evals if live is not None else None, max_steps=max_steps)


def _walk_plain(args, kw):
    """beam_walk_ref on the same arguments (the plain scorer of the store)."""
    from repro_torch.kernels.beam_step import beam_walk_ref

    (pool_ids, pool_scores, checked, visited, done, evals, queries, adj, rows, scales, live,
     dead) = args
    return beam_walk_ref(pool_ids, pool_scores, checked, visited, done, evals, queries, adj,
                         rows, score_fn=_plain_scorer(scales), live=live, dead_evals=dead, **kw)


WALK_FIELDS = ("pool_ids", "pool_scores", "pool_checked", "visited", "evals", "dead_evals",
               "row_steps")


def _check_walk(name, got, want, exact: bool):
    """Every output of two walks bit-identical, steps included (``exact``);
    else (float inputs against the plain version, whose scores differ in
    the last bits) the final pools within the tolerance contract: a near-tie
    ordered the other way can send a row's walk elsewhere on its way to the
    same pool, so visited and the counts are held on integer inputs only.
    Returns (near-tie rows, rows whose visited differs)."""
    import torch

    if exact:
        assert got.steps == want.steps, f"{name}: steps {got.steps} != {want.steps}"
        for field in WALK_FIELDS:
            x, y = getattr(got, field), getattr(want, field)
            assert (x is None) == (y is None), f"{name}: {field}"
            if x is not None:
                assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                                   y.view(torch.int32) if y.dtype == torch.float32 else y), \
                    f"{name}: {field} differs"
        return 0, 0
    tied = _check_topk(name, got.pool_ids, got.pool_scores, want.pool_ids, want.pool_scores,
                       False)
    return tied, int((got.visited != want.visited).any(-1).sum())


def _walk_bound(args, res, max_steps: int, expanded: int):
    """(ms, by) for one walk: each distinct adjacency row it expanded and
    each distinct item row it scored read once (int8: codes and scale; with
    a mask one live byte), the queries, pools and seed evals read, the pools
    and counts written, and the visited columns of the steps the rows ran
    written once; 2 d flops per scored neighbour."""
    import torch

    pool_ids, queries, adj, rows, scales, live = (args[0], args[6], args[7], args[8], args[9],
                                                  args[10])
    b, l = pool_ids.shape
    d = rows.shape[1]
    m = adj.shape[1]
    cols = res.visited[:, res.visited.shape[1] - max_steps * m:]
    scored = torch.unique(cols[cols >= 0]).numel()
    row_bytes = d * 4 if scales is None else d + 4
    nbytes = (expanded * m * 4 + scored * (row_bytes + (live is not None))
              + b * d * 4 + 2 * b * l * 9 + b * (1 + 4 + 4 + 4)
              + int(res.row_steps.sum()) * m * 4)
    n_scored = int((res.evals - args[5]).sum())
    return bound(nbytes, 2.0 * d * n_scored)


def _expanded_nodes(args, kw) -> int:
    """Distinct nodes whose adjacency rows the walk read: the chosen slot's
    id of every step that advanced, from a host loop of the plain version."""
    import torch

    from repro_torch.kernels.beam_step import beam_step_ref, host_walk

    (_, _, _, _, _, _, queries, adj, rows, scales, live, _) = args
    chosen = []

    def step(ids, scores, checked, vis, dn):
        unchecked = ~checked & (ids >= 0)
        slot = torch.where(unchecked, torch.arange(ids.shape[1], device=ids.device),
                           ids.shape[1]).min(-1).values
        upd = ~dn & (slot < ids.shape[1])
        chosen.append(ids.gather(1, slot.clamp_max(ids.shape[1] - 1)[:, None])[upd, 0])
        return beam_step_ref(ids, scores, checked, vis, dn, queries, adj, rows,
                             score_fn=_plain_scorer(scales), live=live)

    fresh = _fresh(args)
    host_walk(step, *fresh[:6], fresh[11] if live is not None else None, **kw)
    return torch.unique(torch.cat(chosen)).numel() if chosen else 0


def phase_beam_walk(items_by_kind, stores_by_kind, g) -> dict:
    """beam_walk in every variant (f32, int8, each without and with a
    tombstone mask over about half the items) at the main path's walks, and
    at pad rows, a max_steps cut and a large ef whose visited rows stay in
    device memory: every output bit-identical to the host loop of the
    beam_step kernel on any input, and to beam_walk_ref on integer inputs
    (float inputs: the tolerance contract).  Returns the timings of the
    four variants at the search IP shape, float inputs."""
    import torch

    from repro_torch.kernels.beam_step import beam_walk
    from repro_torch.kernels.beam_step.ops import VISITED_SHARED_MAX

    out = {}
    # d = 37: the scalar loads (repro::row_score) instead of the 16-byte ones
    narrow = {kind: _int_or_float((20_000, 37), kind == "int", g) for kind in items_by_kind}
    narrow_stores = {kind: _int8_store(x, kind == "int", g) for kind, x in narrow.items()}
    cells = [(variant, walk, shape, {}) for variant in ("f32", "int8")
             for walk, shape in WALK_SHAPES.items()]
    cells += [("f32", "search_ip_pad_rows", WALK_SHAPES["search_ip"], {"pad_rows": True}),
              ("int8", "search_ip_max_steps_cut", (*WALK_SHAPES["search_ip"][:4], 6), {}),
              ("f32", "search_ip_long", WALK_LONG, {}),
              ("f32", "large_v_ef400", WALK_LARGE_V, {}),
              ("f32", "search_ip_d37", WALK_SHAPES["search_ip"], {}),
              ("int8", "search_ip_d37", WALK_SHAPES["search_ip"], {})]
    for variant, walk, shape, opts in cells:
        for kind in items_by_kind:
            items, stores = ((narrow, narrow_stores) if walk.endswith("d37")
                             else (items_by_kind, stores_by_kind))
            items = items[kind]
            rows, scales = (items, None) if variant == "f32" else stores[kind]
            half_dead = torch.rand(rows.shape[0], generator=g, device=rows.device) >= 0.5
            for mask in (None, half_dead):
                tag = variant if mask is None else f"{variant}_live"
                args, kw = _walk_inputs(shape, rows, scales, kind == "int", mask, g, **opts)
                got = beam_walk(*_fresh(args), **kw)
                loop = per_step_walk(*_fresh(args), **kw)
                plain = _walk_plain(_fresh(args), kw)
                torch.cuda.synchronize()
                name = f"beam_walk[{tag}] {walk}/{kind}"
                _check_walk(f"{name} vs the beam_step loop", got, loop, True)
                tied, strayed = _check_walk(f"{name} vs beam_walk_ref", got, plain,
                                            kind == "int")
                assert got.steps == int(got.row_steps.max()), f"{name}: steps"
                b, l, m, s, max_steps = shape
                v = s + max_steps * m
                done = args[4]
                assert got.steps > 0 and bool((got.row_steps[done] == 0).all()), \
                    f"{name}: a row done on entry took a step"
                if mask is not None:
                    assert int((got.dead_evals - args[11]).sum()) > 0, f"{name}: no dead eval"
                if opts.get("pad_rows"):
                    assert bool((got.visited[done] == -1).all()) and bool(
                        (got.evals[done] == 0).all()), f"{name}: a pad row was walked"
                if walk.endswith("max_steps_cut"):
                    assert got.steps == max_steps, f"{name}: the walk was not cut"
                if walk.endswith("long"):
                    assert got.steps < max_steps, f"{name}: max_steps cut the walk"
                err = _max_abs_err(got.pool_scores, plain.pool_scores)
                line = (f"kernel=beam_walk variant={tag} walk={walk} inputs={kind} B={b} L={l} "
                        f"M={m} S={s} V={v} d={rows.shape[1]} max_steps={max_steps} "
                        f"visited_in_shared={v <= VISITED_SHARED_MAX} steps={got.steps} "
                        f"mean_row_steps={float(got.row_steps.float().mean()):.2f} "
                        f"near_tie_rows={tied} rows_walked_elsewhere_than_plain={strayed} "
                        f"max_abs_err={err:.3g}")
                timed = walk == "search_ip" or (walk == "large_v_ef400" and mask is None)
                if kind == "float" and timed:
                    reps = 10 if walk == "search_ip" else 3
                    run = lambda: beam_walk(*_fresh(args), **kw)  # noqa: E731
                    ms = device_ms(run, reps=reps, only="beam_walk_kernel", once=True)
                    loop_ms = device_ms(lambda: per_step_walk(*_fresh(args), **kw), reps=reps,
                                        only="beam_step")
                    call_ms = cuda_ms(run, reps=reps)
                    loop_call_ms = cuda_ms(lambda: per_step_walk(*_fresh(args), **kw), reps=reps)
                    bound_ms, by = _walk_bound(args, got, max_steps, _expanded_nodes(args, kw))
                    line += (f" ms={ms:.4f} call_ms={call_ms:.4f} step_loop_ms={loop_ms:.4f} "
                             f"step_loop_call_ms={loop_call_ms:.4f} library_ms=None "
                             f"bound_ms={bound_ms:.5f} bound_by={by} "
                             f"us_per_step={ms / got.steps * 1e3:.3f}")
                    if walk == "search_ip":
                        plain_ms = device_ms(lambda: _walk_plain(_fresh(args), kw), reps=3)
                        line += f" plain_ms={plain_ms:.4f}"
                        out[tag] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                        bound_by=by, library_ms=None, max_abs_err=err)
                log(line + f" launches={getattr(beam_walk, _WALK_COUNTERS[tag])}")
    return out


_WALK_COUNTERS = {"f32": "launches", "int8": "launches_int8", "f32_live": "launches_live",
                  "int8_live": "launches_int8_live"}


def _score_ids(b: int, w: int, n: int, g):
    """[B, W] ids as the walk gives them: hub-skewed repeats and 10% -1."""
    import torch

    ids = torch.randint(0, n, (b, w), generator=g, device="cuda", dtype=torch.int32)
    hubs = torch.rand((b, w), generator=g, device="cuda") < 0.2
    ids[hubs] = torch.randint(0, 64, (int(hubs.sum()),), generator=g, device="cuda",
                              dtype=torch.int32)
    ids[torch.rand((b, w), generator=g, device="cuda") < 0.1] = -1
    return ids


def _check_scores(name, got, want, integer: bool) -> float:
    """Integer inputs: bit-identical; float inputs: the tolerance contract.
    -inf where and only where the plain version has it."""
    import torch

    from repro_torch.testing import scores_close

    if integer:
        assert torch.equal(got, want), f"{name}: scores differ on integer inputs"
    else:
        ok = scores_close(got.cpu().numpy(), want.cpu().numpy())
        assert ok.all(), f"{name}: {int((~ok).sum())} scores outside the tolerance"
    assert torch.equal(torch.isinf(got), torch.isinf(want)), f"{name}: -inf slots differ"
    return _max_abs_err(got, want)


def _scorer_witness(name: str, q, rows, scales, ids):
    """The previous one-warp-a-row kernel on the same inputs
    (gather_score_rowwise_f32 / quant_score_rowwise_i8): the yardstick the
    redesigned scorer is held to bit for bit and timed against.  Launched
    here only, through no wrapper, so it counts in no launch counter."""
    import torch

    from repro_torch.kernels import _lib

    (b, d), w = q.shape, ids.shape[1]
    out = torch.empty((b, w), dtype=torch.float32, device=q.device)
    stream = _lib.stream(q.device)
    if name == "quant_score":
        rc = _lib.lib().quant_score_rowwise_i8(q.data_ptr(), rows.data_ptr(), scales.data_ptr(),
                                               ids.data_ptr(), b, w, d, out.data_ptr(), stream)
    else:
        rc = _lib.lib().gather_score_rowwise_f32(q.data_ptr(), rows.data_ptr(), ids.data_ptr(),
                                                 b, w, d, out.data_ptr(), stream)
    _lib.check(rc, f"{name} witness")
    return out


def _poisoned(fn, shape):
    """``fn()`` right after a NaN-filled block of ``shape`` was freed: the
    output the wrapper allocates is that block, so a slot the kernel does
    not write reads NaN, not an earlier run's score."""
    import torch

    torch.full(shape, float("nan"), device="cuda")
    return fn()


_L2_FLUSH = []  # a 128 MB buffer, written before each cold launch (the L2 holds 50 MB)


def _cold(fn):
    """``fn`` with 128 MB written before each call: the rows it gathers come
    from device memory, as for a caller that has not just touched them.
    Time it with ``device_ms(..., only=<its kernel>)``, which leaves the
    fill out."""
    import torch

    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(1 << 25, device="cuda"))
    return lambda: (_L2_FLUSH[0].zero_(), fn())[1]


def _scorer_bound(name: str, ids, d: int):
    """(ms, by): each distinct row read once -- a -1 id reads no row of the
    int8 store (quant_score) or row 0 (gather_score clamps) -- plus ids,
    scores and queries; 2 d flops a scored slot (each kernel's
    ``launch_cost``, given this run's distinct rows and scored slots)."""
    import torch

    from repro_torch.kernels.gather_score.ops import launch_cost as gather_cost
    from repro_torch.kernels.quant_score.ops import launch_cost as quant_cost

    b, w = ids.shape
    if name == "gather_score":
        flops, nbytes = gather_cost(b, w, d, distinct=torch.unique(ids.clamp_min(0)).numel())
    else:
        flops, nbytes = quant_cost(b, w, d, distinct=torch.unique(ids[ids >= 0]).numel(),
                                   scored=int((ids >= 0).sum()))
    return bound(nbytes, flops)


def phase_scorers(items_by_kind, stores_by_kind, g) -> dict:
    """quant_score at the int8 seed shapes and gather_score at the f32 seed
    and rerank shapes, and both at their edges (SCORER_EDGES): on every
    input bit-identical to the witness, the previous one-warp-a-row kernel
    (``_scorer_witness``), and held to the plain version (integer inputs
    bit-identical, float inputs the tolerance contract, -inf slots equal).
    At the main shapes, float inputs, the kernel and the witness are timed
    in turns (kernel, witness, witness, kernel), back to back as the other
    kernels are (rows that fit the L2 stay there between calls), and again
    with the L2 flushed before each call (``_cold``: cold_ms).  Returns the
    timings at the IP seed shape, float."""
    import torch

    from repro_torch.kernels.gather_score import gather_score, gather_score_ref
    from repro_torch.kernels.quant_score import quant_score, quant_score_ref

    out = {}
    # d = 37 (scalar loads) and d = 512 (two rounds of loads) over their own rows
    other_d = {dd: {kind: _int_or_float((20_000, dd), kind == "int", g) for kind in items_by_kind}
               for dd in {d for _, _, d, _ in SCORER_EDGES.values()} - {D_FULL}}
    cases = [("quant_score", cell, (b, w, D_FULL, False), True)
             for cell, (b, w) in QUANT_SHAPES.items()]
    cases += [("gather_score", cell, (b, w, D_FULL, False), True)
              for cell, (b, w) in GATHER_SHAPES.items()]
    cases += [(name, cell, shape, False) for name in ("quant_score", "gather_score")
              for cell, shape in SCORER_EDGES.items()]
    for name, cell, (b, w, d, dead_row), timed in cases:
        for kind in items_by_kind:
            items = items_by_kind[kind] if d == D_FULL else other_d[d][kind]
            codes, scales = (stores_by_kind[kind] if d == D_FULL
                             else _int8_store(items, kind == "int", g))
            q = _int_or_float((b, d), kind == "int", g)
            ids = _score_ids(b, w, items.shape[0], g)
            if dead_row:
                ids[0] = -1
            if name == "quant_score":
                run = lambda: quant_score(q, codes, scales, ids)  # noqa: E731
                plain = lambda: quant_score_ref(q, codes, scales, ids)  # noqa: E731
                witness = lambda: _scorer_witness(name, q, codes, scales, ids)  # noqa: E731
                fn = quant_score
            else:
                run = lambda: gather_score(q, items, ids)  # noqa: E731
                plain = lambda: gather_score_ref(q, items, ids)  # noqa: E731
                witness = lambda: _scorer_witness(name, q, items, None, ids)  # noqa: E731
                fn = gather_score
            got = _poisoned(run, (b, w))
            wit, want = witness(), plain()
            torch.cuda.synchronize()
            tag = f"{name} {cell}/{kind} B={b} W={w} d={d}"
            assert torch.equal(got.view(torch.int32), wit.view(torch.int32)), \
                f"{tag}: {int((got.view(torch.int32) != wit.view(torch.int32)).sum())} " \
                f"scores differ from the witness's bits"
            err = _check_scores(tag, got, want, kind == "int")
            line = (f"kernel={name} cell={cell} inputs={kind} B={b} W={w} d={d} "
                    f"witness_bit_identical=True max_abs_err={err:.3g}")
            if timed and kind == "float":
                turns = [device_ms(f) for f in (run, witness, witness, run)]
                ms, witness_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
                cold = [device_ms(_cold(f), only=f"{name}_{k}kernel")
                        for f, k in ((run, ""), (witness, "rowwise_"), (witness, "rowwise_"),
                                     (run, ""))]
                cold_ms, witness_cold_ms = (cold[0] + cold[3]) / 2, (cold[1] + cold[2]) / 2
                plain_ms = device_ms(plain)
                call_ms = cuda_ms(run)
                bound_ms, by = _scorer_bound(name, ids, d)
                line += (f" ms={ms:.4f} witness_ms={witness_ms:.4f} turns={turns[0]:.4f}/"
                         f"{turns[1]:.4f}/{turns[2]:.4f}/{turns[3]:.4f} call_ms={call_ms:.4f} "
                         f"plain_ms={plain_ms:.4f} library_ms=None bound_ms={bound_ms:.5f} "
                         f"bound_by={by} share_of_bound={bound_ms / ms:.3f} "
                         f"over_witness={witness_ms / ms:.3f} cold_ms={cold_ms:.4f} "
                         f"witness_cold_ms={witness_cold_ms:.4f} cold_turns="
                         f"{'/'.join(f'{t:.4f}' for t in cold)} "
                         f"cold_share_of_bound={bound_ms / cold_ms:.3f}")
                if cell == "seed_ip":
                    out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                                     library_ms=None, max_abs_err=err)
            log(line + f" launches={fn.launches}")
    return out


def _commit_inputs(items, batch: int, m: int, g):
    """One build batch's reverse-link proposals: the last ``batch`` items
    propose themselves to M distinct, hub-skewed targets each (10% -1); a
    tenth of the proposals repeat an edge their target already has."""
    import torch

    n = items.shape[0]
    dev = items.device
    adj = torch.randint(0, n - batch, (n, m), generator=g, device=dev, dtype=torch.int32)
    adj[torch.rand((n, m), generator=g, device=dev) < 0.1] = -1
    weights = 1.0 / torch.arange(1, n - batch + 1, device=dev, dtype=torch.float32)
    targets = torch.multinomial(weights.expand(batch, -1), m, replacement=False,
                                generator=g).to(torch.int32)
    targets[torch.rand((batch, m), generator=g, device=dev) < 0.1] = -1
    bids = torch.arange(n - batch, n, device=dev, dtype=torch.int32)
    adj[bids.long()] = torch.where(targets >= 0, targets, -1)  # forward rows first
    cands = bids[:, None].expand(-1, m)
    repeat = (targets >= 0) & (torch.rand((batch, m), generator=g, device=dev) < 0.1)
    slot = torch.randint(0, m, (batch, m), generator=g, device=dev)
    adj[targets[repeat].long(), slot[repeat]] = cands[repeat]
    scores = (items[targets.clamp_min(0).long()] * items[cands.long()]).sum(-1)
    return adj, targets.reshape(-1), cands.reshape(-1).contiguous(), scores.reshape(-1)


def phase_commit_merge(items_by_kind, g) -> dict:
    """commit_merge at each COMMIT_SHAPES cell: the kernel against its plain
    version on the same sorted proposals (and, on integer items, the whole
    commit against the two-sort oracle), no foreign row written, and one
    whole commit under torch.cuda.set_sync_debug_mode("error"): a read-back
    from the card anywhere in the pre-pass or the launch fails the run."""
    import torch

    from repro_torch.kernels.commit_merge import (
        commit_merge, commit_merge_ref, commit_rows, commit_rows_ref, sort_proposals,
    )

    out = {}
    for graph, (batch, m) in COMMIT_SHAPES.items():
        for kind, items in items_by_kind.items():
            adj0, targets, cands, scores = _commit_inputs(items, batch, m, g)
            props = sort_proposals(adj0.shape[0], targets, cands, scores)
            work = adj0.clone()
            commit_rows(work, items, props)
            tgt, rows_p = commit_rows_ref(adj0, items, *props)
            rows_k = work[tgt]
            torch.cuda.synchronize()
            untouched = torch.ones(adj0.shape[0], dtype=torch.bool, device=adj0.device)
            untouched[tgt] = False
            assert torch.equal(work[untouched], adj0[untouched]), "commit_merge wrote a foreign row"
            rs = lambda r: torch.where(  # noqa: E731 -- plain scores of a row's ids
                r >= 0, (items[tgt][:, None, :] * items[r.clamp_min(0).long()]).sum(-1),
                float("-inf"))
            near = _check_topk(f"commit_merge {graph}/{kind}", rows_k, rs(rows_k),
                               rows_p, rs(rows_p), kind == "int")
            full = adj0.clone()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                commit_merge(full, items, targets, cands, scores)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert torch.equal(full, work), f"commit_merge {graph}: the commit != its kernel's rows"
            if kind == "int":
                assert torch.equal(full, commit_merge_ref(adj0, items, targets, cands, scores)), \
                    f"commit_merge {graph}: kernel path != two-sort commit_merge_ref"
            # each launch merges into a fresh copy of the rows (copy time excluded)
            ms = device_ms(lambda: (work.copy_(adj0), commit_rows(work, items, props)),
                           only="commit_merge_kernel")
            kernel_call_ms = cuda_ms(lambda: commit_rows(work, items, props))
            call_ms = cuda_ms(lambda: commit_merge(work, items, targets, cands, scores))
            plain_ms = device_ms(lambda: commit_rows_ref(adj0, items, *props))
            # the existing edges the kernel rescores: >= 0, not repeating an
            # earlier slot, not repeated by a proposal of the same target
            t_s, c_s = props.targets.long(), props.cands.long()
            pair = torch.cat([torch.ones(1, dtype=torch.bool, device=t_s.device),
                              (t_s[1:] != t_s[:-1]) | (c_s[1:] != c_s[:-1])])
            prop = (t_s >= 0) & (c_s >= 0) & pair
            u, p, d = tgt.shape[0], int(prop.sum()), items.shape[1]
            run = torch.bincount(t_s[t_s >= 0])
            ex = adj0[tgt].long()
            seg = torch.searchsorted(tgt, t_s[prop])
            live = ex >= 0
            for j in range(m):
                live[:, j] &= ~(ex[:, :j] == ex[:, j: j + 1]).any(-1)
                live[seg[c_s[prop] == ex[seg, j]], j] = False
            n_rescored = int(live.sum())
            # the sorted proposals, the touched rows and target vectors, the rescored
            # neighbour rows read; the touched rows written
            nbytes = targets.shape[0] * 12 + u * m * 4 + u * d * 4 + n_rescored * d * 4 + u * m * 4
            bound_ms, by = bound(nbytes, 2.0 * d * n_rescored)
            err = _max_abs_err(rs(rows_k), rs(rows_p))
            log(f"kernel=commit_merge graph={graph} inputs={kind} E={targets.shape[0]} U={u} "
                f"P={p} P_per_U={p / max(u, 1):.2f} longest_run={int(run.max())} M={m} d={d} "
                f"ms={ms:.4f} kernel_call_ms={kernel_call_ms:.4f} call_ms={call_ms:.4f} "
                f"plain_ms={plain_ms:.4f} "
                f"library_ms=None bound_ms={bound_ms:.5f} bound_by={by} near_tie_rows={near} "
                f"max_abs_err={err:.3g} launches={commit_merge.launches} "
                f"no_read_back=True")
            if graph == "ip" and kind == "float":
                out = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                           library_ms=None, max_abs_err=err)
    # a width that is no multiple of 4: the rescore's scalar loads
    batch, m = COMMIT_SHAPES["ip"]
    for kind, items in items_by_kind.items():
        items = items[:, :37].contiguous()
        adj0, targets, cands, scores = _commit_inputs(items, batch, m, g)
        work = commit_merge(adj0.clone(), items, targets, cands, scores)
        tgt, rows_p = commit_rows_ref(adj0, items, *sort_proposals(adj0.shape[0], targets, cands,
                                                                   scores))
        want = adj0.clone()
        want[tgt] = rows_p
        if kind == "int":
            assert torch.equal(work, want), "commit_merge d=37: kernel != plain version"
            assert torch.equal(work, commit_merge_ref(adj0, items, targets, cands, scores))
        rs = lambda r: torch.where(  # noqa: E731
            r >= 0, (items[tgt][:, None, :] * items[r.clamp_min(0).long()]).sum(-1),
            float("-inf"))
        near = _check_topk(f"commit_merge d=37/{kind}", work[tgt], rs(work[tgt]), rows_p,
                           rs(rows_p), kind == "int")
        log(f"kernel=commit_merge edge=d37 inputs={kind} near_tie_rows={near}")
    return out


def phase_mips_topk(g) -> dict:
    """mips_topk over fp32 items and over the int8 store (the quantized
    scan), at both MIPS_SHAPES."""
    import torch

    from repro_torch.kernels.mips_topk import mips_topk, mips_topk_ref, mips_topk_select
    from repro_torch.kernels.mips_topk.ops import launch_cost, select_cost, select_plan

    out = {}
    for variant in ("f32", "int8"):
        for cell, (b, n, d, k) in MIPS_SHAPES.items():
            for kind in ("int", "float"):
                q = _int_or_float((b, d), kind == "int", g)
                x = _int_or_float((n, d), kind == "int", g)
                if variant == "f32":
                    scales = None
                    library = lambda: torch.topk(torch.matmul(q, x.T), k, dim=1)  # noqa: E731
                else:
                    x, scales = _int8_store(x, kind == "int", g)
                    library = None
                run = lambda: mips_topk(q, x, scales, k=k)  # noqa: E731
                plain = lambda: mips_topk_ref(q, x, k=k, scales=scales)  # noqa: E731
                (s_k, i_k), (s_p, i_p) = run(), plain()
                torch.cuda.synchronize()
                rows = _check_topk(f"mips_topk[{variant}] {cell}/{kind}", i_k, s_k, i_p, s_p,
                                   kind == "int")
                err = _max_abs_err(s_k, s_p)
                ms = device_ms(run)
                call_ms = cuda_ms(run)
                plain_ms = device_ms(plain)
                library_ms = device_ms(library) if library is not None else None
                flops, nbytes = launch_cost(b, n, d, k, int8=variant == "int8")
                bound_ms, by = bound(nbytes, flops)
                launches = mips_topk.launches if variant == "f32" else mips_topk.launches_int8
                log(f"kernel=mips_topk variant={variant} cell={cell} inputs={kind} B={b} N={n} "
                    f"d={d} k={k} ms={ms:.4f} call_ms={call_ms:.4f} plain_ms={plain_ms:.4f} "
                    f"library_ms={library_ms if library_ms is None else f'{library_ms:.4f}'} "
                    f"bound_ms={bound_ms:.5f} bound_by={by} near_tie_rows={rows} "
                    f"max_abs_err={err:.3g} launches={launches}")
                if kind == "float" and cell != "serve_default":
                    _log_roofline(f"mips_topk[{variant}] {cell}", flops, ms, bound_ms,
                                  library_ms, pass2_ms=device_ms(run, only="merge"))
                if cell == "full" and kind == "float":
                    out[variant] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                        bound_by=by, library_ms=library_ms, max_abs_err=err)
                del q, x, scales
        for cell, (b, n, d, k) in MIPS_EDGE_SHAPES.items():
            for kind in ("int", "float"):
                q = _int_or_float((b, d), kind == "int", g)
                x = _int_or_float((n, d), kind == "int", g)
                scales = None
                if variant == "int8":
                    x, scales = _int8_store(x, kind == "int", g)
                (s_k, i_k), (s_p, i_p) = mips_topk(q, x, scales, k=k), mips_topk_ref(
                    q, x, k=k, scales=scales)
                torch.cuda.synchronize()
                rows = _check_topk(f"mips_topk[{variant}] {cell}/{kind}", i_k, s_k, i_p, s_p,
                                   kind == "int")
                log(f"kernel=mips_topk variant={variant} edge={cell} inputs={kind} B={b} N={n} "
                    f"d={d} k={k} near_tie_rows={rows} max_abs_err={_max_abs_err(s_k, s_p):.3g}")
        for cell, (b, n, d, k) in {**MIPS_WIDE_SHAPES, **MIPS_TIED_SHAPES}.items():
            for kind in ("int", "float"):
                q = _int_or_float((b, d), kind == "int", g)
                x = _int_or_float((n, d), kind == "int", g)
                if cell in MIPS_TIED_SHAPES:  # one row repeated: every score of a query ties
                    x = x[:1].expand(n, d).contiguous()
                scales = None
                if variant == "int8":
                    x, scales = _int8_store(x, kind == "int", g)
                run = lambda: mips_topk(q, x, scales, k=k)  # noqa: E731
                plain = lambda: mips_topk_ref(q, x, k=k, scales=scales)  # noqa: E731
                (s_k, i_k), (s_p, i_p) = run(), plain()
                _, _, cands = mips_topk_select(q, x, scales, k=k)
                torch.cuda.synchronize()
                rows = _check_topk(f"mips_topk[{variant}] {cell}/{kind}", i_k, s_k, i_p, s_p,
                                   kind == "int")
                err = _max_abs_err(s_k, s_p)
                cands = cands.float()
                line = (f"kernel=mips_topk variant={variant} route=select cell={cell} "
                        f"inputs={kind} B={b} N={n} d={d} k={k} near_tie_rows={rows} "
                        f"max_abs_err={err:.3g} candidates_median={cands.median().item():.0f} "
                        f"candidates_max={cands.max().item():.0f} "
                        f"rows_from_scores={int((cands > select_plan(n, k)[1]).sum())}")
                if kind == "float":
                    library = None if variant == "int8" else (
                        lambda: torch.topk(torch.matmul(q, x.T), k, dim=1))
                    ms = device_ms(run)
                    select_ms = device_ms(run, only="select")  # the four select kernels
                    call_ms = cuda_ms(run)
                    plain_ms = device_ms(plain)
                    library_ms = device_ms(library) if library is not None else None
                    flops, nbytes = launch_cost(b, n, d, k, int8=variant == "int8")
                    bound_ms, by = bound(nbytes, flops)
                    # the select alone: two reads of the scratch, candidates and out written
                    select_bound_ms, _ = bound(select_cost(b, n, k, cands.sum().item())[1], 0)
                    line += (f" ms={ms:.4f} select_ms={select_ms:.4f} "
                             f"select_bound_ms={select_bound_ms:.5f} call_ms={call_ms:.4f} "
                             f"plain_ms={plain_ms:.4f} "
                             f"library_ms={library_ms if library_ms is None else f'{library_ms:.4f}'}"
                             f" bound_ms={bound_ms:.5f} bound_by={by}")
                    _log_roofline(f"mips_topk[{variant}] select {cell}", flops, ms, bound_ms,
                                  library_ms, select_ms=select_ms)
                    if cell == "full_k33":
                        out[f"select_{variant}"] = dict(ms=ms, plain_ms=plain_ms,
                                                        bound_ms=bound_ms, bound_by=by,
                                                        library_ms=library_ms, max_abs_err=err)
                log(line)
                del q, x, scales
    return out


# the recsys cells' kernels (phase 9) at their shapes over a 10^6-row table:
# mips_topk's select route at retrieval_cand (B, N, d, k) -- SASRec's and
# DIEN's user vector, MIND's four interests -- and gather_score's rerank at
# serve_p99 / serve_bulk (B, W, d), MIND's rows B x K = 512 x 4 over the
# same ids
RECSYS_ROWS = 1_000_000
MIPS_RECSYS_SHAPES = {"sasrec_retrieval": (1, RECSYS_ROWS, 50, 100),
                      "dien_retrieval": (1, RECSYS_ROWS, 18, 100),
                      "mind_retrieval": (4, RECSYS_ROWS, 64, 100)}
GATHER_RECSYS_SHAPES = {"sasrec_serve_p99": (512, 1_000, 50), "mind_serve_p99": (2_048, 1_000, 64),
                        "sasrec_serve_bulk": (262_144, 1_000, 50)}
PLAIN_CHUNK = 8_192  # rows a plain gather_score call takes at serve_bulk ([B, W, d] in memory)


def _chunked(fn, rows: int):
    """``fn(q, items, ids)`` over chunks of ``rows`` query rows, concatenated."""
    import torch

    return lambda q, items, ids: torch.cat([fn(q[s: s + rows], items, ids[s: s + rows])
                                            for s in range(0, q.shape[0], rows)])


def phase_recsys_kernels(g) -> None:
    """mips_topk (select route) and gather_score at the recsys cells'
    shapes: bit-identical to the plain version on integer inputs, the
    tolerance contract on float inputs; gather_score also to its witness's
    bits.  ms, plain_ms, bound and, for mips_topk, library_ms
    (torch.topk(q @ x.T)); launches of the check."""
    import torch

    from repro_torch.kernels.gather_score import gather_score, gather_score_ref
    from repro_torch.kernels.mips_topk import mips_topk, mips_topk_ref, mips_topk_select
    from repro_torch.kernels.mips_topk.ops import launch_cost

    for cell, (b, n, d, k) in MIPS_RECSYS_SHAPES.items():
        for kind in ("int", "float"):
            q = _int_or_float((b, d), kind == "int", g)
            x = _int_or_float((n, d), kind == "int", g)
            run = lambda: mips_topk(q, x, k=k)  # noqa: E731
            plain = lambda: mips_topk_ref(q, x, k=k)  # noqa: E731
            (s_k, i_k), (s_p, i_p) = run(), plain()
            cands = mips_topk_select(q, x, k=k)[2].float()
            torch.cuda.synchronize()
            rows = _check_topk(f"mips_topk {cell}/{kind}", i_k, s_k, i_p, s_p, kind == "int")
            err = _max_abs_err(s_k, s_p)
            line = (f"kernel=mips_topk route=select cell={cell} inputs={kind} B={b} N={n} d={d} "
                    f"k={k} near_tie_rows={rows} max_abs_err={err:.3g} "
                    f"candidates_max={cands.max().item():.0f}")
            if kind == "float":
                library = lambda: torch.topk(torch.matmul(q, x.T), k, dim=1)  # noqa: E731
                ms = _device_ms_or_none(run)
                select_ms = _device_ms_or_none(run, only="select")
                call_ms = cuda_ms(run)
                plain_ms = _device_ms_or_none(plain)
                library_ms = _device_ms_or_none(library)
                flops, nbytes = launch_cost(b, n, d, k)
                bound_ms, by = bound(nbytes, flops)
                line += (f" ms={_ms(ms)} select_ms={_ms(select_ms)} call_ms={call_ms:.4f} "
                         f"plain_ms={_ms(plain_ms)} library_ms={_ms(library_ms)} "
                         f"bound_ms={bound_ms:.5f} bound_by={by}")
                if ms is not None and library_ms is not None:
                    line += (f" share_of_bound={bound_ms / ms:.4f} "
                             f"ms_over_library_ms={ms / library_ms:.3f}")
            log(line + f" launches={mips_topk.launches_select}")
            del q, x
    for cell, (b, w, d) in GATHER_RECSYS_SHAPES.items():
        for kind in ("int", "float"):
            items = _int_or_float((RECSYS_ROWS, d), kind == "int", g)
            q = _int_or_float((b, d), kind == "int", g)
            if cell.startswith("mind"):  # a user's K = 4 interests score its ids
                ids = _score_ids(b // 4, w, RECSYS_ROWS, g).repeat_interleave(4, dim=0)
            else:
                ids = _score_ids(b, w, RECSYS_ROWS, g)
            plain_fn = _chunked(gather_score_ref, PLAIN_CHUNK) if b > PLAIN_CHUNK \
                else gather_score_ref
            run = lambda: gather_score(q, items, ids)  # noqa: E731
            plain = lambda: plain_fn(q, items, ids)  # noqa: E731
            got = _poisoned(run, (b, w))
            wit, want = _scorer_witness("gather_score", q, items, None, ids), plain()
            torch.cuda.synchronize()
            tag = f"gather_score {cell}/{kind} B={b} W={w} d={d}"
            assert torch.equal(got.view(torch.int32), wit.view(torch.int32)), \
                f"{tag}: scores differ from the witness's bits"
            err = _check_scores(tag, got, want, kind == "int")
            line = (f"kernel=gather_score cell={cell} inputs={kind} B={b} W={w} d={d} "
                    f"witness_bit_identical=True max_abs_err={err:.3g}")
            if kind == "float":
                if b > PLAIN_CHUNK:
                    # launches of 100-200 ms: CUDA events (host gaps are
                    # nothing beside them); profiling them left the
                    # profiler dropping events for the phases after
                    ms = call_ms = cuda_ms(run, reps=5, warmup=1)
                    plain_ms = cuda_ms(plain, reps=2, warmup=1)
                else:
                    ms = _device_ms_or_none(run)
                    call_ms = cuda_ms(run)
                    plain_ms = _device_ms_or_none(plain)
                bound_ms, by = _scorer_bound("gather_score", ids, d)
                share = "not measured" if ms is None else f"{bound_ms / ms:.3f}"
                line += (f" ms={_ms(ms)} call_ms={call_ms:.4f} plain_ms={_ms(plain_ms)}"
                         f"{' (chunks of %d rows; CUDA events)' % PLAIN_CHUNK if b > PLAIN_CHUNK else ''} "
                         f"library_ms=None bound_ms={bound_ms:.5f} bound_by={by} "
                         f"share_of_bound={share}")
            log(line + f" launches={gather_score.launches}")
            del items, q, ids, got, wit, want
    torch.cuda.empty_cache()


def _log_roofline(name: str, flops: float, ms: float, bound_ms: float, library_ms, **extra):
    """The redesigned kernels' line: achieved TFLOP/s, share of the bound,
    and time over one PyTorch call's."""
    ratio = "none" if library_ms is None else f"{ms / library_ms:.3f}"
    log(f"roofline {name}: tflops={flops / ms / 1e9:.2f} share_of_bound={bound_ms / ms:.4f} "
        f"ms_over_library_ms={ratio} " + " ".join(f"{k}={v:.4f}" for k, v in extra.items()))


def _merge_inputs(shape, integer: bool, g):
    """A walk's merge at ``shape``: a pool sorted as lax.top_k sorts it with
    an empty (-inf, -1) tail, and M new candidates with about a quarter
    invalid (-inf, -1); integer scores with exact ties and +-0 pairs, or
    float scores."""
    import torch

    from repro_torch.core.similarity import top_l

    b, l, m = shape

    def scores(cols):
        if integer:
            s = torch.randint(-4, 5, (b, cols), generator=g, device="cuda").float()
            neg = torch.rand((b, cols), generator=g, device="cuda") < 0.5
            return torch.where((s == 0) & neg, -0.0, s)
        return torch.randn((b, cols), generator=g, device="cuda")

    pool_s = scores(l)
    pool_i = torch.randint(0, N_FULL, (b, l), generator=g, device="cuda", dtype=torch.int32)
    n_empty = torch.randint(0, l // 2 + 1, (b, 1), generator=g, device="cuda")
    empty = torch.arange(l, device="cuda") >= l - n_empty
    pool_s = torch.where(empty, float("-inf"), pool_s)
    pool_i = torch.where(empty, -1, pool_i)
    pool_s, order = top_l(pool_s, l)
    pool_i = pool_i.gather(1, order)
    pool_c = ((torch.rand((b, l), generator=g, device="cuda") < 0.5) | (pool_i < 0)).int()
    new_s = scores(m)
    new_i = torch.randint(0, N_FULL, (b, m), generator=g, device="cuda", dtype=torch.int32)
    bad = torch.rand((b, m), generator=g, device="cuda") < 0.25
    new_s = torch.where(bad, float("-inf"), new_s)
    new_i = torch.where(bad, -1, new_i)
    return pool_s, pool_i, pool_c, new_s, new_i, bad.int()


def _merge_grid(b: int, c: int):
    """topk_merge's route and launch grid (blocks, threads) for B rows of C
    candidates, as csrc/topk_merge.cu launches them: up to C = 64 the sort
    route, a warp a row and 8 rows a block; past 64 the rank route, a block
    of 128 threads a row."""
    if c > 64:
        return "rank", (b, 128)
    return "sort", ((b + 7) // 8, 256)


def phase_topk_merge(g) -> dict:
    """topk_merge at the walk's merge shapes and at MERGE_WIDE_SHAPES against
    topk_merge_ref: a pure selection, so ids, flags and score bits are equal
    on integer and float inputs alike.  Beside each cell, the device time of
    an empty kernel on the same grid: the launch floor."""
    import torch

    from repro_torch.kernels import _lib
    from repro_torch.kernels.topk_merge import topk_merge, topk_merge_ref

    out = {}
    for cell, (b, l, m) in {**MERGE_SHAPES, **MERGE_WIDE_SHAPES}.items():
        route, grid = _merge_grid(b, l + m)
        floor_ms = None
        for kind in ("int", "float"):
            args = _merge_inputs((b, l, m), kind == "int", g)
            run = lambda: topk_merge(*args)  # noqa: E731
            plain = lambda: topk_merge_ref(*args)  # noqa: E731
            got, want = run(), plain()
            torch.cuda.synchronize()
            name = f"topk_merge {cell}/{kind}"
            for x, y, what in zip(got, want, ("scores", "ids", "checked")):
                assert torch.equal(x.view(torch.int32), y.view(torch.int32)), f"{name}: {what}"
            if kind == "int":
                zeros = want[0] == 0
                assert bool((zeros & torch.signbit(want[0])).any()) and bool(
                    (zeros & ~torch.signbit(want[0])).any()), f"{name}: no +-0 pair kept"
            assert bool((args[1] < 0).any()) and bool((args[4] < 0).any()), f"{name}: no -1 slot"
            err = _max_abs_err(got[0], want[0])
            if floor_ms is None:
                stream = _lib.stream(torch.device("cuda"))
                floor_ms = device_ms(lambda: _lib.check(_lib.lib().empty_launch(*grid, stream),
                                                        "empty_launch"))
            ms = device_ms(run)
            plain_ms = device_ms(plain)
            call_ms = cuda_ms(run)
            bound_ms, by = bound(b * (l + m) * 12 + b * l * 12, 0.0)
            log(f"kernel=topk_merge cell={cell} inputs={kind} B={b} L={l} M={m} "
                f"route={route} ms={ms:.4f} call_ms={call_ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms=None bound_ms={bound_ms:.5f} bound_by={by} "
                f"share_of_bound={bound_ms / ms:.4f} floor_ms={floor_ms:.4f} "
                f"(empty kernel, {grid[0]} x {grid[1]}) max_abs_err={err:.3g} "
                f"launches={topk_merge.launches}")
            if cell == "search_ip" and kind == "float":
                out = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                           library_ms=None, max_abs_err=err)
            del args, got, want
    return out


def _sdpa_mask(q, k, q_offset: int, window):
    """None where the mask is plain causal (SDPA's flag), else the [S, T]
    boolean mask."""
    import torch

    s, t = q.shape[1], k.shape[1]
    if not (q_offset or window is not None or s != t):
        return None
    qi = q_offset + torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(t, device=q.device)[None, :]
    mask = ki <= qi
    if window is not None:
        mask &= ki > qi - window
    return mask


def _sdpa(q, k, v, q_offset: int, window):
    """The library yardstick: one scaled_dot_product_attention call on the
    same inputs (heads first, grouped heads by ``enable_gqa``), causal by
    flag where the mask is plain causal, else by a boolean mask."""
    import torch.nn.functional as F

    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    mask = _sdpa_mask(q, k, q_offset, window)
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                  is_causal=mask is None, enable_gqa=True)


def _flash_spread(q, k, v, q_offset: int, window):
    """sqrt(sum_t p_t^2 v_t^2) per output, [B, S, H, hd], in fp32 from the
    same inputs: p from fp32 scores, masked as the plain version masks."""
    import torch

    s, t, hd = q.shape[1], k.shape[1], q.shape[3]
    g = q.shape[2] // k.shape[2]
    qh = q.float().transpose(1, 2)
    kh, vh = (x.float().repeat_interleave(g, 2).transpose(1, 2) for x in (k, v))
    qi = q_offset + torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(t, device=q.device)[None, :]
    ok = ki <= qi
    if window is not None:
        ok &= ki > qi - window
    p = torch.softmax((qh @ kh.transpose(-1, -2) / hd ** 0.5).masked_fill(~ok, float("-inf")),
                      dim=-1).nan_to_num_(0.0)
    return (p.square_() @ vh.square()).sqrt_().transpose(1, 2)


def _flash_readings(name: str, diff, want, spread, rtol: float) -> None:
    """Logs the largest error, and its excess over ``rtol * |want|`` (alone
    and over the spread), by bin of |want| and by query row: the readings
    the tolerance is set from."""
    import torch

    a = want.abs()
    excess = diff - rtol * a
    ratio = excess / spread.clamp_min(1e-30)
    edges = (0.0, 2**-10, 2**-8, 2**-6, 2**-4, 2**-2, 1.0, 2.0, 4.0, float("inf"))
    bins = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        m = (a >= lo) & (a < hi)
        if bool(m.any()):
            bins.append(f"[{lo:g},{hi:g}):n={int(m.sum())},err={float(diff[m].max()):.3g},"
                        f"excess={float(excess[m].max()):.3g}")
    s = want.shape[1]
    cuts = sorted({min(max(x, 0), s) for x in (0, 16, 256, s - 64, s)})
    rows = [f"rows[{lo},{hi}):excess={float(excess[:, lo:hi].max()):.3g},"
            f"excess/spread={float(ratio[:, lo:hi].max()):.3g}"
            for lo, hi in zip(cuts[:-1], cuts[1:])]
    log(f"flash_attn readings {name} rtol={rtol:g}: " + " ".join(bins + rows)
        + f" values_differing={int((diff > 0).sum())} of {diff.numel()}"
        + f" median_abs_out={float(torch.median(a.flatten()[::97])):.3g}"
        + f" median_spread={float(torch.median(spread.flatten()[::97])):.3g}")


def _check_flash(name: str, got, want, spread, tol):
    """Asserts |got - want| <= atol + rtol * |want| + c * spread everywhere
    (and got finite); logs the readings; returns the largest error and the
    largest excess over ``rtol * |want|`` divided by the spread."""
    import torch

    rtol, atol, c = tol
    assert bool(torch.isfinite(got).all()), f"flash_attn {name}: not finite"
    want = want.float()
    diff = (got.float() - want).abs()
    _flash_readings(name, diff, want, spread, rtol)
    bad = diff > atol + rtol * want.abs() + c * spread
    err = float(diff.max())
    assert not bool(bad.any()), (f"flash_attn {name}: {int(bad.sum())} values outside "
                                 f"rtol={rtol:g} atol={atol:g} c={c:g}, max_abs_err={err}")
    return err, float(((diff - rtol * want.abs()) / spread.clamp_min(1e-30)).max())


def _flash_inputs(shape, dtype, g):
    import torch

    b, s, t, h, kv, hd = shape[:6]
    return tuple(torch.randn(dims, generator=g, device="cuda").to(dtype)
                 for dims in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd)))


def _rows_without_keys(s: int, t: int, q_offset: int, window):
    """[S] bool: the query rows with no key in their window."""
    import torch

    pos = q_offset + torch.arange(s, device="cuda")
    seen = torch.minimum(pos, torch.tensor(t - 1, device="cuda")) + 1
    if window is not None:
        seen -= torch.clamp(pos - window + 1, min=0)
    return seen <= 0


def check_flash_cell(cell: str, shape, dtype, g):
    """flash_attention on seeded inputs at ``shape`` held to the plain version
    in the same dtype (FLASH_TOL), bf16 also to the plain version in fp32 on
    the same values, with p's bf16 rounding showing (FLASH_BF16_VS_FP32);
    rows with no key in their window must be exactly 0.  Returns (q, k, v,
    largest error, rows without keys)."""
    import torch

    from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref

    b, s, t, h, kv, hd, off, win = shape
    q, k, v = _flash_inputs(shape, dtype, g)
    got = flash_attention(q, k, v, q_offset=off, window=win)
    want = flash_attention_ref(q, k, v, q_offset=off, window=win)
    torch.cuda.synchronize()
    dname = str(dtype).split(".")[-1]
    spread = _flash_spread(q, k, v, off, win)
    err, _ = _check_flash(f"{cell}/{dname}", got, want, spread, FLASH_TOL[dname])
    empty = _rows_without_keys(s, t, off, win)
    assert bool((got[:, empty] == 0).all()), (
        f"flash_attn {cell}/{dname}: a row with no key is not 0")
    if dtype == torch.bfloat16:
        exact = flash_attention_ref(q.float(), k.float(), v.float(), q_offset=off, window=win)
        _, rounded = _check_flash(f"{cell}/{dname} vs fp32 plain", got, exact, spread,
                                  FLASH_BF16_VS_FP32)
        if not bool(empty.all()):
            assert rounded >= FLASH_P_ROUNDED, (
                f"flash_attn {cell}/{dname}: within {rounded:.3g} spread of fp32 arithmetic, "
                f"p was not rounded to bf16")
    return q, k, v, err, int(empty.sum())


def phase_flash_attn(g) -> dict:
    """flash_attention at granite-3-2b's and gemma3-12b's local attention
    widths, fp32 and bf16, and at the edges, against flash_attention_ref in
    the same dtype (check_flash_cell); each model cell timed beside SDPA and
    its bound, the fp32 kernel with its registers and spills."""
    import torch

    from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref
    from repro_torch.kernels.flash_attn.ops import forward_cost

    out = {}
    for cell, shape in FLASH_SHAPES.items():
        b, s, t, h, kv, hd, off, win = shape
        for dtype in (torch.float32, torch.bfloat16):
            if cell.endswith("_offset") and dtype == torch.bfloat16:
                continue
            q, k, v, err, _ = check_flash_cell(cell, shape, dtype, g)
            run = lambda: flash_attention(q, k, v, q_offset=off, window=win)  # noqa: E731
            plain = lambda: flash_attention_ref(q, k, v, q_offset=off, window=win)  # noqa: E731
            dname = str(dtype).split(".")[-1]
            library = _sdpa(q, k, v, off, win)
            ms = device_ms(run, reps=5)
            plain_ms = device_ms(plain, reps=5)
            library_ms = device_ms(library, reps=5)
            call_ms = cuda_ms(run, reps=5)
            flops, nbytes = forward_cost(b, s, t, h, kv, hd, off, win, q.element_size())
            rate = FP32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S
            bound_ms, by = bound(nbytes, flops, rate)
            usage = ""
            if dtype == torch.float32:
                regs = ptxas_usage(f"flash_attn_f32_kernelILi{hd}E")
                usage = " ".join(f"registers={r} spill_stores={st} spill_loads={ld}"
                                 for r, st, ld in regs.values())
            log(f"kernel=flash_attn cell={cell} dtype={dname} B={b} S={s} T={t} H={h} KV={kv} "
                f"hd={hd} q_offset={off} window={win} flops={flops:.4g} ms={ms:.4f} "
                f"call_ms={call_ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
                f"bound_ms={bound_ms:.5f} bound_by={by} (rate {rate / 1e12:.0f} TFLOP/s) "
                f"share_of_bound={bound_ms / ms:.4f} rtol, atol, c={FLASH_TOL[dname]} "
                f"max_abs_err={err:.3g} {usage}")
            _log_roofline(f"flash_attn[{dname}] {cell}", flops, ms, bound_ms, library_ms)
            if cell == "granite_3_2b":
                key = "flash_attn" if dtype == torch.float32 else "flash_attn_bf16"
                out[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                                library_ms=library_ms, max_abs_err=err)
            del q, k, v
            torch.cuda.empty_cache()
    for cell, shape in FLASH_EDGE_SHAPES.items():
        b, s, t, h, kv, hd, off, win = shape
        for dtype in (torch.float32, torch.bfloat16):
            *_, err, n_empty = check_flash_cell(cell, shape, dtype, g)
            log(f"kernel=flash_attn edge={cell} dtype={str(dtype).split('.')[-1]} B={b} S={s} "
                f"T={t} H={h} KV={kv} hd={hd} q_offset={off} window={win} "
                f"rows_without_keys={n_empty} max_abs_err={err:.3g}")
    return out


def phase_entry_points(g) -> dict:
    """topk_merge, flash_attn, the per-step beam_step kernels (the walks
    launch beam_walk) and the int8 select route of mips_topk have no system
    caller: their path is their own public entry point.  Each is driven
    once (topk_merge and flash_attn at every shape above, beam_step in its
    four variants at the search IP step, mips_topk at k = 33 over an int8
    store), with the counts set to 0 just before; returns the counts read
    just after."""
    import torch

    from repro_torch.kernels.beam_step import beam_step
    from repro_torch.kernels.flash_attn import flash_attention, flash_attention_head
    from repro_torch.kernels.mips_topk import mips_topk
    from repro_torch.kernels.topk_merge import topk_merge

    merges = [_merge_inputs(shape, False, g) for shape in MERGE_SHAPES.values()]
    items = _int_or_float((N_FULL, D_FULL), False, g)
    codes, scales = _int8_store(items, False, g)
    half_dead = torch.rand(N_FULL, generator=g, device="cuda") >= 0.5
    steps = [(_beam_state(BEAM_SHAPES["search_ip"], rows, sc, False, g), sc, live)
             for rows, sc in ((items, None), (codes, scales)) for live in (None, half_dead)]
    q = _int_or_float((256, 64), False, g)
    wide = _int8_store(_int_or_float((20_000, 64), False, g), False, g)
    _zero_counts()
    for args in merges:
        topk_merge(*args)
    for args, sc, live in steps:
        beam_step(*args, sc, live)
    mips_topk(q, *wide, k=33)
    for (b, s, t, h, kv, hd, off, win) in FLASH_SHAPES.values():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _flash_inputs((b, s, t, h, kv, hd), dtype, g)
            out = flash_attention(q, k, v, q_offset=off, window=win)
            assert out.shape == q.shape and bool(torch.isfinite(out).all())
            head = flash_attention_head(*(x[0, :, 0].contiguous() for x in (q, k, v)),
                                        q_offset=off, window=win)
            assert head.shape == (s, hd) and bool(torch.isfinite(head).all())
    torch.cuda.synchronize()
    counts = _read_counts()
    log(f"entry points topk_merge / flash_attention / flash_attention_head / beam_step / "
        f"mips_topk (k 33, int8): launches={counts}")
    for name in ENTRY_ONLY:
        assert counts[name] > 0, f"{name} was not launched: {counts}"
    return {name: counts[name] for name in ENTRY_ONLY}


def phase_kernels() -> dict:
    import torch

    warm_up_profiler()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    items_by_kind = {kind: _int_or_float((N_FULL, D_FULL), kind == "int", g)
                     for kind in ("int", "float")}
    stores_by_kind = {kind: _int8_store(items, kind == "int", g)
                      for kind, items in items_by_kind.items()}
    beam = phase_beam_step(items_by_kind, stores_by_kind, g)
    scorers = phase_scorers(items_by_kind, stores_by_kind, g)
    commit = phase_commit_merge(items_by_kind, g)
    mips = phase_mips_topk(g)
    merge = phase_topk_merge(g)
    flash = phase_flash_attn(g)
    walk = phase_beam_walk(items_by_kind, stores_by_kind, g)
    torch.cuda.empty_cache()
    timings = {
        "beam_step": beam["f32"],
        "beam_step_int8": beam["int8"],
        "beam_step_live": beam["f32_live"],
        "beam_step_int8_live": beam["int8_live"],
        "beam_walk": walk["f32"],
        "beam_walk_int8": walk["int8"],
        "beam_walk_live": walk["f32_live"],
        "beam_walk_int8_live": walk["int8_live"],
        "commit_merge": commit,
        "mips_topk": mips["f32"],
        "mips_topk_int8": mips["int8"],
        "mips_topk_select": mips["select_f32"],
        "mips_topk_select_int8": mips["select_int8"],
        "quant_score": scorers["quant_score"],
        "gather_score": scorers["gather_score"],
        "topk_merge": merge,
        "flash_attn": flash["flash_attn"],
        "flash_attn_bf16": flash["flash_attn_bf16"],
    }
    log(f"kernels: {', '.join(timings)} -- each equal to its plain version")
    return timings, phase_entry_points(g)


def _kernel_counters():
    """name -> (wrapper, attribute of its launch count)."""
    from repro_torch.kernels.beam_step import beam_step, beam_walk
    from repro_torch.kernels.commit_merge import commit_merge
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.gather_score import gather_score
    from repro_torch.kernels.mips_topk import mips_topk
    from repro_torch.kernels.quant_score import quant_score
    from repro_torch.kernels.topk_merge import topk_merge

    return {"beam_step": (beam_step, "launches"),
            "beam_step_int8": (beam_step, "launches_int8"),
            "beam_step_live": (beam_step, "launches_live"),
            "beam_step_int8_live": (beam_step, "launches_int8_live"),
            "beam_walk": (beam_walk, "launches"),
            "beam_walk_int8": (beam_walk, "launches_int8"),
            "beam_walk_live": (beam_walk, "launches_live"),
            "beam_walk_int8_live": (beam_walk, "launches_int8_live"),
            "commit_merge": (commit_merge, "launches"),
            "mips_topk": (mips_topk, "launches"),
            "mips_topk_int8": (mips_topk, "launches_int8"),
            "mips_topk_select": (mips_topk, "launches_select"),
            "mips_topk_select_int8": (mips_topk, "launches_select_int8"),
            "quant_score": (quant_score, "launches"),
            "gather_score": (gather_score, "launches"),
            "topk_merge": (topk_merge, "launches"),
            "flash_attn": (flash_attention, "launches"),
            "flash_attn_bf16": (flash_attention, "launches_bf16"),
            "flash_attn_bwd": (flash_attention, "launches_bwd"),
            "flash_attn_bwd_bf16": (flash_attention, "launches_bwd_bf16")}


def _zero_counts() -> None:
    from repro_torch.kernels.beam_step import beam_walk

    for fn, attr in _kernel_counters().values():
        setattr(fn, attr, 0)
    beam_walk.steps = 0
    for by_width in _widths().values():
        by_width.clear()
    for tally in _IN_GRAPHS.values():
        tally.clear()


def _widths() -> dict:
    """The gathered scorers' launches by W, the ids' width (plain dicts)."""
    from repro_torch.kernels.gather_score import gather_score
    from repro_torch.kernels.quant_score import quant_score

    return {"gather_score": gather_score.launches_by_width,
            "quant_score": quant_score.launches_by_width}


def _wrapper_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in _kernel_counters().items()}


# A wrapper called while a CUDA graph is captured records its kernel into the
# graph, which launches it at every replay.  So a kernel's launches are its
# wrapper's calls outside captures, plus its calls inside each capture times
# that graph's replays.
_GRAPH_KERNELS: dict = {}  # id(graph) -> {kernel: wrapper calls inside its capture}
_IN_GRAPHS = {"recorded": {}, "replayed": {}}  # since the last _zero_counts


def _tally(into: dict, counts: dict) -> None:
    for name, n in counts.items():
        into[name] = into.get(name, 0) + n


def count_graph_launches() -> None:
    """Patch torch.cuda.CUDAGraph so that each capture records the wrapper
    calls made inside it and each replay adds them to the launch counts."""
    import torch

    cls = torch.cuda.CUDAGraph
    begin, end, replay = cls.capture_begin, cls.capture_end, cls.replay

    def capture_begin(graph, *args, **kwargs):
        _GRAPH_KERNELS[id(graph)] = _wrapper_counts()
        begin(graph, *args, **kwargs)

    def capture_end(graph):
        end(graph)
        before, after = _GRAPH_KERNELS[id(graph)], _wrapper_counts()
        inside = {name: after[name] - before[name] for name in after
                  if after[name] != before[name]}
        _GRAPH_KERNELS[id(graph)] = inside
        _tally(_IN_GRAPHS["recorded"], inside)

    def counted_replay(graph):
        replay(graph)
        _tally(_IN_GRAPHS["replayed"], _GRAPH_KERNELS.get(id(graph), {}))

    cls.capture_begin, cls.capture_end, cls.replay = capture_begin, capture_end, counted_replay


def _read_counts() -> dict:
    """Each kernel's launches since the last ``_zero_counts``: its
    wrapper's calls, less those made while a graph was captured (they
    launched nothing), plus the launches of every graph replay."""
    counts = _wrapper_counts()
    for name in counts:
        counts[name] += (_IN_GRAPHS["replayed"].get(name, 0)
                         - _IN_GRAPHS["recorded"].get(name, 0))
    return counts


# the per-step kernels: the walks launch beam_walk, these only their entry
# point (and the per-step loop that phase 3 and the before/after runs time)
STEP_KERNELS = ("beam_step", "beam_step_int8", "beam_step_live", "beam_step_int8_live")


@contextlib.contextmanager
def uncounted():
    """Inside, launches happen but are taken back out of the counts on
    exit: the launches made to time a kernel or to compare it with its
    plain version are not the path's."""
    from repro_torch.kernels.beam_step import beam_walk

    counters = _kernel_counters()
    saved = _wrapper_counts()
    steps = beam_walk.steps
    widths = {name: dict(by_width) for name, by_width in _widths().items()}
    graphs = {name: dict(tally) for name, tally in _IN_GRAPHS.items()}
    try:
        yield
    finally:
        for name, (fn, attr) in counters.items():
            setattr(fn, attr, saved[name])
        beam_walk.steps = steps
        for name, by_width in _widths().items():
            by_width.clear()
            by_width.update(widths[name])
        for name, tally in _IN_GRAPHS.items():
            tally.clear()
            tally.update(graphs[name])


def _walk_steps() -> int:
    """Walk steps so far: beam_walk's step counts, and one a launch of the
    per-step kernel (the per-step loop)."""
    from repro_torch.kernels.beam_step import beam_walk

    counts = _read_counts()
    return beam_walk.steps + sum(counts[name] for name in STEP_KERNELS)


def _assert_path(label: str, counts: dict, path) -> None:
    """Every kernel of ``path`` launched, and no per-step kernel: a system
    path walks with beam_walk."""
    assert all(counts[name] > 0 for name in path), f"{label}: a kernel was not launched: {counts}"
    assert not any(counts[name] for name in STEP_KERNELS), \
        f"{label}: a per-step kernel was launched: {counts}"


# kernels each serve path must launch (the exact scan runs once, the walks
# score their seeds with gather_score or quant_score); --k 33 takes the
# select route of the exact scan
SERVE_PATHS = {
    "f32": (JAX_SERVE_RECALL, [], ("beam_walk", "commit_merge", "mips_topk", "gather_score")),
    "int8": (JAX_SERVE_RECALL_INT8, [], ("beam_walk", "beam_walk_int8", "commit_merge",
                                         "mips_topk", "quant_score", "gather_score")),
    "f32_k33": (None, ["--k", "33"], ("beam_walk", "commit_merge", "mips_topk_select",
                                      "gather_score")),
    # the scan build driver: the graph is the host driver's, so the recall
    # must be the host run's exactly
    "f32_scan": (JAX_SERVE_RECALL, ["--build-backend", "scan"],
                 ("beam_walk", "commit_merge", "mips_topk", "gather_score")),
    "int8_scan": (JAX_SERVE_RECALL_INT8, ["--build-backend", "scan"],
                  ("beam_walk", "beam_walk_int8", "commit_merge", "mips_topk", "quant_score",
                   "gather_score")),
}


def phase_serve_default() -> dict:
    """The serve one-shots; returns the launches of the --k 33 run.  A
    ``_scan`` run (``--build-backend scan``) must give its host run's
    recall exactly."""
    from repro_torch.launch import serve

    recalls, launches = {}, {}
    for name, (jax_recall, flags, path) in SERVE_PATHS.items():
        storage = name.split("_")[0]
        _zero_counts()
        res = serve.main(["--index", "ipnsw_plus", "--storage", storage, *flags])
        counts = launches[name] = _read_counts()
        recalls[name] = res["recall"]
        if name.endswith("_scan"):
            assert res["recall"] == recalls[storage], \
                f"serve {name}: recall {res['recall']} != the host driver's {recalls[storage]}"
        log(f"serve default {name}: recall@k={res['recall']:.4f} "
            f"(JAX {jax_recall}) evals/q={res['evals_per_query']:.1f} "
            f"search_ms={res['search_seconds'] * 1e3:.3f} launches={counts}")
        if jax_recall is not None:
            assert abs(res["recall"] - jax_recall) <= RECALL_MARGIN, \
                f"serve {storage} recall {res['recall']} not within {RECALL_MARGIN} of JAX {jax_recall}"
        else:
            assert res["recall"] > 0.5, f"serve {name}: recall {res['recall']}"
        _assert_path(f"serve {name}", counts, path)
    return launches["f32_k33"]


def phase_full_size() -> dict:
    import torch

    from repro_torch.core.brute_force import exact_topk
    from repro_torch.core.invariants import assert_graph_invariants
    from repro_torch.core.ipnsw import IpNSW
    from repro_torch.core.ipnsw_plus import IpNSWPlus
    from repro_torch.kernels.mips_topk import mips_topk
    from repro_torch.obs.recall import recall_at_k
    from repro_torch.data import mips_dataset, mips_queries

    items = torch.as_tensor(mips_dataset(N_FULL, D_FULL, "lognormal", seed=0), device="cuda")
    queries = torch.as_tensor(mips_queries(256, D_FULL, seed=1), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    _, gt = exact_topk(queries, items, k=10)
    gt = gt.cpu().numpy()
    searched = {}
    for name, cls in (("ipnsw_plus", IpNSWPlus), ("ipnsw", IpNSW)):
        t0 = time.perf_counter()
        index = cls(max_degree=16, ef_construction=32, insert_batch=512).build(items)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        graphs = ([("ang", index.ang_graph), ("ip", index.ip_graph)]
                  if name == "ipnsw_plus" else [("ip", index.graph)])
        for gname, graph in graphs:
            assert_graph_invariants(graph, name=f"{name}/{gname}")
        recall = {}
        for storage in ("f32", "int8"):
            index.search(queries, k=10, ef=40, storage=storage)  # warm-up (int8: the store)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = index.search(queries, k=10, ef=40, storage=storage)
            torch.cuda.synchronize()
            search_s = time.perf_counter() - t0
            recall[storage] = recall_at_k(r.ids.cpu().numpy(), gt)
            searched[name, storage] = (index, r, recall[storage])
            log(f"full size {name}: storage={storage} N={N_FULL} d={D_FULL} B=256 k=10 ef=40 "
                f"build_s={build_s:.2f} search_ms={search_s * 1e3:.3f} "
                f"qps={256 / search_s:.0f} recall@10={recall[storage]:.4f} "
                f"evals/q={float(r.evals.float().mean()):.1f} invariants I1-I4 hold")
        assert recall["f32"] > 0.5, f"{name} recall@10 {recall['f32']} at full size"
        assert recall["int8"] >= recall["f32"] - RECALL_MARGIN, \
            f"{name} int8 recall@10 {recall['int8']} below f32 {recall['f32']} - {RECALL_MARGIN}"
    # the int8 store's linear scan: quantized scores, no rerank
    store = index.store
    t0 = time.perf_counter()
    _, scan_ids = mips_topk(queries, store.codes, store.scales, k=10)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    scan_recall = recall_at_k(scan_ids.cpu().numpy(), gt)
    log(f"full size int8 quantized scan: recall@10={scan_recall:.4f} "
        f"ms={scan_s * 1e3:.3f} (first call)")
    assert scan_recall > 0.5, f"quantized scan recall@10 {scan_recall}"
    counts = _read_counts()
    log(f"full size peak_memory_bytes={torch.cuda.max_memory_allocated()} launches={counts}")
    log("full size launches by width: " + " ".join(
        f"{name}={dict(sorted(by_width.items()))}" for name, by_width in _widths().items()))
    live = [name for name in counts if name.endswith("_live")]
    _assert_path("full size", counts, [name for name in counts if name not in
                                       live + list(ENTRY_ONLY) + list(K33_PATH) + list(TRAIN_PATH)])
    assert not any(counts[name] for name in live), f"a frozen index launched a live kernel: {counts}"
    phase_walk_before_after(searched, queries, gt)
    phase_scan_build(items, queries, searched)
    phase_profile(items, queries, index)
    return counts


def phase_walk_before_after(searched, queries, gt) -> None:
    """The before and after of the fused walk on one card: a full-size
    search launches one walk kernel a walk (two for ip-NSW+); each search
    again with per-step walks (the host loop of the beam_step kernel),
    every output equal to the fused walk's, recall@10 equal; then
    IpNSW's f32 and int8 searches timed with each, in turns (fused first in
    even pairs)."""
    import numpy as np
    import torch

    from repro_torch.obs.recall import recall_at_k

    walks = ("beam_walk", "beam_walk_int8")
    for (name, storage), (index, fused, recall) in searched.items():
        before = _read_counts()
        index.search(queries, k=10, ef=40, storage=storage)
        launched = sum(_read_counts()[w] - before[w] for w in walks)
        assert launched == (2 if name == "ipnsw_plus" else 1), \
            f"full size {name} {storage}: a search launched {launched} walk kernels"
        with per_step_walks():
            looped = index.search(queries, k=10, ef=40, storage=storage)
        torch.cuda.synchronize()
        for field, x in zip(fused._fields, fused):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, getattr(looped, field)), \
                    f"full size {name} {storage}: {field} differs from the per-step loop's"
            else:
                assert x == getattr(looped, field), f"full size {name} {storage}: {field}"
        rec = recall_at_k(looped.ids.cpu().numpy(), gt)
        assert rec == recall, f"full size {name} {storage}: recall {rec} != {recall}"
        log(f"full size {name} storage={storage}: one search, {launched} walk launch(es); the "
            f"per-step loop's outputs equal the fused walk's, recall@10={rec:.4f} both")
    for storage in ("f32", "int8"):
        index = searched["ipnsw", storage][0]
        times = {"fused": [], "per_step": []}
        for pair in range(6):
            for mode in (("fused", "per_step") if pair % 2 == 0 else ("per_step", "fused")):
                with per_step_walks() if mode == "per_step" else contextlib.nullcontext():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    index.search(queries, k=10, ef=40, storage=storage)
                    torch.cuda.synchronize()
                times[mode].append((time.perf_counter() - t0) * 1e3)
        log(f"full size ipnsw search storage={storage} B=256 ef=40 ms " + " ".join(
            f"{mode}_median={np.median(t):.4f} {mode}={['%.4f' % x for x in t]}"
            for mode, t in times.items())
            + f" speedup={np.median(times['per_step']) / np.median(times['fused']):.2f}")


@contextlib.contextmanager
def watch_replays():
    """Inside, every ``torch.cuda.CUDAGraph.replay`` is counted, with the
    sync debug mode it ran under (2: "error")."""
    import torch

    seen = {"replays": 0, "modes": set()}
    replay = torch.cuda.CUDAGraph.replay

    def counted(graph):
        seen["replays"] += 1
        seen["modes"].add(torch.cuda.get_sync_debug_mode())
        replay(graph)

    torch.cuda.CUDAGraph.replay = counted
    try:
        yield seen
    finally:
        torch.cuda.CUDAGraph.replay = replay


def phase_scan_build(items, queries, searched) -> None:
    """Phase 5c: the scan build driver at full size, for IpNSWPlus and
    IpNSW.  One insertion batch is captured as a CUDA graph and replayed for
    rows 1 .. T-1 of the schedule (row 0 is the eager warm-up), every
    replay under set_sync_debug_mode("error"); adjacency, size, entry and
    entry_norm of every graph equal to the host driver's bit for bit (phase
    5's indexes), and so every search's ids and recall@10; then both drivers
    timed in turns (host, scan, scan, host): build wall s, and for the scan
    its capture ms, host ms per replay and the replay loop's device ms (CUDA
    events)."""
    import numpy as np
    import torch

    from repro_torch.core.build import batch_schedule, replay_schedule
    from repro_torch.core.ipnsw import IpNSW
    from repro_torch.core.ipnsw_plus import IpNSWPlus

    rows = batch_schedule(N_FULL, 512)[1].shape[0]
    for name, cls in (("ipnsw_plus", IpNSWPlus), ("ipnsw", IpNSW)):
        def build(driver):
            return cls(max_degree=16, ef_construction=32, insert_batch=512,
                       build_backend=driver).build(items)

        host = searched[name, "f32"][0]
        _zero_counts()
        with watch_replays() as seen:
            scan = build("scan")
        torch.cuda.synchronize()
        counts = _read_counts()
        n_graphs = 2 if name == "ipnsw_plus" else 1
        assert seen == {"replays": rows - 1, "modes": {2}}, \
            f"scan build {name}: replays {seen}, expected {rows - 1} under sync debug mode 2"
        assert replay_schedule.last.replays == rows - 1
        _assert_path(f"scan build {name}", counts, ("beam_walk", "commit_merge", "gather_score"))
        # row 0's eager warm-up and the replays launch a walk a graph each
        assert counts["beam_walk"] == rows * n_graphs, counts
        gnames = ("ang_graph", "ip_graph") if name == "ipnsw_plus" else ("graph",)
        for gname in gnames:
            for field in ("adj", "size", "entry", "entry_norm"):
                assert torch.equal(getattr(getattr(host, gname), field),
                                   getattr(getattr(scan, gname), field)), \
                    f"scan build {name}: {gname}.{field} differs from the host driver's"
        for storage in ("f32", "int8"):
            _, host_res, host_recall = searched[name, storage]
            res = scan.search(queries, k=10, ef=40, storage=storage)
            assert torch.equal(res.ids, host_res.ids), f"scan build {name} {storage}: ids differ"
            log(f"scan build {name}: storage={storage} recall@10={host_recall:.4f}, ids equal to "
                f"the host driver's index")
        log(f"scan build {name}: {rows} batches of 512, {seen['replays']} graph replays, all "
            f"under sync debug mode error (0 syncs in the replay loop); {', '.join(gnames)} "
            f"adj, size, entry, entry_norm bit-identical to the host driver's; launches={counts}")
        walls = {"host": [], "scan": []}
        runs = []
        for driver in ("host", "scan", "scan", "host"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            build(driver)
            torch.cuda.synchronize()
            walls[driver].append(time.perf_counter() - t0)
            if driver == "scan":
                run = replay_schedule.last
                runs.append((run.capture_ms, run.loop_host_ms / run.replays,
                             run.loop_events[0].elapsed_time(run.loop_events[1])))
        log(f"scan build {name} timings (turns host, scan, scan, host): "
            f"host_build_s={['%.4f' % x for x in walls['host']]} "
            f"scan_build_s={['%.4f' % x for x in walls['scan']]} "
            f"capture_ms={['%.2f' % r[0] for r in runs]} "
            f"host_ms_per_replay={['%.4f' % r[1] for r in runs]} "
            f"replay_loop_device_ms={['%.2f' % r[2] for r in runs]} "
            f"speedup={np.median(walls['host']) / np.median(walls['scan']):.2f}")


class _WatchedClock:
    """A loop clock that records how far each sleep overshot its target
    (the host's scheduling, not the loop's work)."""

    def __init__(self, clock):
        self.clock, self.virtual = clock, clock.virtual
        self.sleeps, self.overshoot_ms, self.overshoot_at = 0, 0.0, 0.0

    def now(self) -> float:
        return self.clock.now()

    def sleep_until(self, t: float) -> None:
        self.clock.sleep_until(t)
        self.sleeps += 1
        late = (self.clock.now() - t) * 1e3
        if late > self.overshoot_ms:
            self.overshoot_ms, self.overshoot_at = late, t


@contextlib.contextmanager
def gc_pauses():
    """Inside, every garbage collection is recorded: (generation, ms)."""
    pauses, t0 = [], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            t0[0] = time.perf_counter()
        else:
            pauses.append((info["generation"], round((time.perf_counter() - t0[0]) * 1e3, 4)))

    gc.callbacks.append(on_gc)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(on_gc)


def _loop_report(label: str, stats, gt) -> dict:
    """Print and return a loop run's metrics: latency percentiles, QPS,
    occupancy, misses, degraded share and recall@10, by request id."""
    import numpy as np

    from repro_torch.obs.recall import recall_at_k

    by_rid = sorted(stats.responses, key=lambda r: r.rid)
    s = stats.summary()
    out = dict(p50_ms=s["p50_ms"], p99_ms=s["p99_ms"], qps=s["qps"], occupancy=s["occupancy"],
               deadline_miss_frac=s["deadline_miss_frac"],
               degraded_share=float(np.mean([r.degraded for r in by_rid])),
               recall=recall_at_k(np.stack([r.ids for r in by_rid]), gt),
               batches=s["batches"], served=s["served"],
               recompiles_warmup=s["recompiles_warmup"],
               recompiles_steady=s["recompiles_steady"],
               ef_served={e: sum(r.ef_served == e for r in by_rid)
                          for e in sorted({r.ef_served for r in by_rid})})
    log(f"loop full {label}: " + " ".join(f"{k}={v!r}" for k, v in out.items()))
    # each dispatch's duration on the loop's clock, and where the longest was
    took = np.asarray([(b.finish_t - b.dispatch_t) * 1e3 for b in stats.batches])
    worst = int(np.argmax(took))
    first = {}
    for b, t in zip(stats.batches, took):
        first.setdefault(f"{b.bucket.batch}x{b.bucket.ef}", (b.seq, round(float(t), 4)))
    log(f"loop full {label}: dispatch_ms median={np.median(took):.4f} p99="
        f"{np.percentile(took, 99):.4f} max={took[worst]:.4f} at seq {worst} "
        f"({stats.batches[worst].bucket}); each bucket's first dispatch (seq, ms)={first}")
    # the longest a batch's first request waited while the loop did not
    # dispatch: after the previous batch finished and after it arrived
    arrival = {r.rid: r.arrival_t for r in by_rid}
    held = [(b.dispatch_t - max(prev.finish_t, min(arrival[i] for i in b.rids))) * 1e3
            for prev, b in zip(stats.batches, stats.batches[1:])]
    if held:
        i = int(np.argmax(held))
        b = stats.batches[i + 1]
        log(f"loop full {label}: longest wait before a dispatch {held[i]:.4f} ms, before seq "
            f"{i + 1} ({len(b.rids)} requests, dispatched at {b.dispatch_t:.4f} s); the first "
            f"dispatch at {stats.batches[0].dispatch_t:.4f} s")
    return out


def phase_loop_full() -> dict:
    """The serving loop at Yahoo!Music's size: an IpNSWPlus over 136,736 x
    300 items, 4,096 Poisson requests at 2,000 QPS in three deadline
    classes, _build_ladder(256, 40); wall clock with the f32 and the int8
    store, and the virtual clock with f32.  Every bucket is a CUDA graph:
    each dispatch of a run replays one."""
    import functools

    import numpy as np
    import torch

    from repro_torch.core.brute_force import exact_topk
    from repro_torch.core.ipnsw_plus import IpNSWPlus
    from repro_torch.data import mips_dataset, mips_queries
    from repro_torch.launch import serve_loop as sl
    from repro_torch.launch.serve import _build_ladder

    items = torch.as_tensor(mips_dataset(N_FULL, D_FULL, "lognormal", seed=0), device="cuda")
    queries = mips_queries(LOOP_FULL_REQUESTS, D_FULL, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    index = IpNSWPlus(max_degree=16, ef_construction=32, insert_batch=512).build(items)
    _zero_counts()  # the serving path: the ground truth, then the three runs
    _, gt = exact_topk(torch.as_tensor(queries, device="cuda"), items, k=10)
    gt = gt.cpu().numpy()
    ladder = _build_ladder(256, 40)
    trace = sl.poisson_trace(queries, rate_qps=LOOP_FULL_RATE, seed=2, ef=40,
                             classes=("interactive", "standard", "relaxed"))
    runs, stats_by, executors, peaks = {}, {}, {}, {}
    for label, storage, clock in (("wall_f32", "f32", sl.WallClock),
                                  ("wall_int8", "int8", sl.WallClock),
                                  ("virtual_f32", "f32", sl.VirtualClock)):
        index.storage = storage
        executor = sl.BucketExecutor(index, ladder, k=10)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        executor.warmup()  # before the clock starts: the trace meets a warm server
        torch.cuda.synchronize()
        graphs_bytes = torch.cuda.memory_allocated() - held
        # set-up, before the clock starts: the earlier phases' garbage (the
        # profiler's events hold one another in cycles) is collected here,
        # not inside the timed run
        t0 = time.perf_counter()
        freed = gc.collect()
        log(f"loop full {label}: before the run, {freed} objects of garbage collected in "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        loop = sl.ServeLoop(index, ladder=ladder, clock=_WatchedClock(clock()),
                            executor=executor, service_model=sl.LinearServiceModel())
        with watch_replays() as seen, gc_pauses() as pauses:
            stats = loop.run(trace)
        log(f"loop full {label}: clock sleeps {loop.clock.sleeps}, longest overshoot "
            f"{loop.clock.overshoot_ms:.4f} ms waking at {loop.clock.overshoot_at:.4f} s")
        log(f"loop full {label}: garbage collections in the run {len(pauses)}, ms "
            f"total={sum(ms for _, ms in pauses):.4f} longest={max(pauses, key=lambda x: x[1])}"
            if pauses else f"loop full {label}: no garbage collection in the run")
        stats_by[label], executors[label] = stats, executor
        runs[label] = _loop_report(label, stats, gt)
        assert runs[label]["served"] == LOOP_FULL_REQUESTS, f"{label}: a request was not answered"
        assert runs[label]["recompiles_steady"] == 0, f"{label}: a steady-state build"
        assert runs[label]["recall"] > 0.5, f"{label}: recall {runs[label]['recall']}"
        _assert_replays(f"loop full {label}", seen, runs[label]["batches"])
        peaks[label] = torch.cuda.max_memory_allocated()
        log(f"loop full {label}: the six bucket graphs hold {graphs_bytes} bytes")
    counts = _read_counts()
    peak = max(peaks.values())
    # the same buckets dispatched eagerly, in a fresh peak window
    for label in ("wall_f32", "wall_int8"):
        index.storage = label.split("_")[1]
        _check_replays_equal_eager(f"loop full {label}", executors[label], queries)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for bucket in ladder.buckets():
        _eager_bucket(executors["wall_int8"], bucket)
    index.storage = "f32"
    for bucket in ladder.buckets():
        _eager_bucket(executors["wall_f32"], bucket)
    log(f"loop full: peak_memory_bytes with captured buckets {peaks}; eager dispatches of "
        f"every bucket, f32 and int8: {torch.cuda.max_memory_allocated()}")
    # A response depends only on its query and its served ef (padding and
    # batch composition do not change a row), so the virtual and the wall
    # f32 runs must agree on every request served at the same ef.
    wall = {r.rid: r for r in stats_by["wall_f32"].responses}
    virt = {r.rid: r for r in stats_by["virtual_f32"].responses}
    same = [rid for rid in wall if wall[rid].ef_served == virt[rid].ef_served]
    assert all(np.array_equal(wall[r].ids, virt[r].ids) for r in same), \
        "wall and virtual runs differ on a request served at the same ef"
    log(f"loop full: requests served at the same ef in the wall and virtual f32 runs "
        f"{len(same)} of {LOOP_FULL_REQUESTS}, ids identical on all of them; "
        f"peak_memory_bytes={peak} launches={counts}")
    _assert_path("loop full", counts, ("beam_walk", "beam_walk_int8", "mips_topk", "quant_score",
                                       "gather_score"))
    full = sl.Bucket(256, 40)
    executor = executors["wall_f32"]
    dispatch = functools.partial(executor.run, full, queries[:256], np.ones(256, bool))
    dispatch()  # the program's buffers now hold what the eager runs search
    label = "loop dispatch of a full 256x40 bucket, f32"
    with per_step_walks():
        _profiled(f"{label} [eager, per-step loop]",
                  lambda: _eager_bucket(executor, full, capturable=False), batches=1, reps=20)
    _profiled(f"{label} [eager]", lambda: _eager_bucket(executor, full), batches=1, reps=20)
    _profiled(f"{label} [captured]", dispatch, batches=1, reps=20)
    return runs


# kernels the observability phase must launch: the builds, the ground truth,
# the walks (f32, int8), the seeds' and the traces' scorers
OBS_PATH = ("beam_walk", "beam_walk_int8", "commit_merge", "mips_topk", "gather_score",
            "quant_score")
# timed loop runs a mode, after one warm run: JAX's obs_overhead takes the
# min of the first 3; the spread between runs of one mode is wider than the
# recording's cost, so 10 are run and their min and median printed too
OBS_REPEATS, OBS_JAX_REPEATS = 10, 3


def _check_traced_search(label: str, index, queries, ctx, storage: str) -> float:
    """A full-size search traced and untraced: every output bit-identical;
    the trace's band_hist rows sum to the (G_s) walk's evals and equal a
    host bincount of the visited ids' bands, its ids are the visited
    prefix, hub_evals <= evals.  Returns the batch's top-band share."""
    import numpy as np
    import torch

    from repro_torch.core.ipnsw_plus import IpNSWPlus
    from repro_torch.obs import top_band_share

    base = index.search(queries, k=10, ef=40, storage=storage)
    r = index.search(queries, k=10, ef=40, storage=storage, trace=ctx)
    plus = isinstance(index, IpNSWPlus)
    fields = (("ids", "scores", "evals", "ang_evals", "ip_evals", "visited_ang", "visited_ip")
              if plus else ("ids", "scores", "evals", "visited", "dead_evals"))
    for field in fields:
        a, b = getattr(base, field), getattr(r, field)
        assert (a is None and b is None) or torch.equal(a, b), \
            f"{label}: {field} differs under tracing"
    assert plus or base.steps == r.steps, f"{label}: steps differ under tracing"
    evals, visited, tr = (r.ip_evals, r.visited_ip, r.trace) if plus else (r.evals, r.visited,
                                                                            r.trace)
    assert torch.equal(tr.band_hist.sum(dim=1), evals), f"{label}: band_hist.sum(1) != evals"
    assert torch.equal(tr.ids, visited[:, :ctx.trace_cap]), f"{label}: ids != visited prefix"
    assert bool((tr.hub_evals <= evals).all()), f"{label}: hub_evals > evals"
    vis, bands = visited.cpu().numpy(), ctx.band_ids.cpu().numpy()
    rows = np.broadcast_to(np.arange(vis.shape[0])[:, None], vis.shape)
    ok = vis >= 0
    host = np.bincount(rows[ok] * ctx.n_bands + bands[vis[ok]],
                       minlength=vis.shape[0] * ctx.n_bands).reshape(-1, ctx.n_bands)
    assert np.array_equal(tr.band_hist.cpu().numpy(), host), f"{label}: band_hist != bincount"
    pads = tr.ids.cpu().numpy() < 0
    sc = tr.scores.cpu().numpy()
    assert np.isneginf(sc[pads]).all() and np.isfinite(sc[~pads]).all(), f"{label}: scores"
    share = top_band_share(tr.band_hist.sum(dim=0).cpu().numpy())
    log(f"{label}: traced search B={queries.shape[0]} ef=40 bit-identical to the untraced one "
        f"({', '.join(fields)}); band_hist rows = evals and = a host bincount; trace ids = "
        f"visited[:, :{ctx.trace_cap}]; hub_evals {int(tr.hub_evals.sum())} of "
        f"{int(evals.sum())} evals; steps_to_converge mean "
        f"{float(tr.steps_to_converge.float().mean()):.2f}; top_band_share={share:.4f}")
    return share


@contextlib.contextmanager
def _timed_methods(*targets):
    """Inside, each ``(cls, name)`` method's calls and host seconds are
    accumulated into ``{name: [calls, seconds]}``."""
    spent, saved = {}, []
    for cls, name in targets:
        fn = getattr(cls, name)
        spent[name] = [0, 0.0]

        def timed(*args, _fn=fn, _acc=spent[name], **kwargs):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                _acc[0] += 1
                _acc[1] += time.perf_counter() - t0

        saved.append((cls, name, fn))
        setattr(cls, name, timed)
    try:
        yield spent
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


def _record_per_response(reg, bucket, batch, now: float, finish: float, degraded: bool) -> None:
    """The JAX loop's ``_record_dispatch`` (``src/repro/launch/serve_loop.py``)
    without a trace: a histogram observe a response twice and an event a
    response, one call a dispatch.  The plain version of the port's queued
    and folded recording."""
    n = len(batch)
    reg.counter("serve_requests_total", "requests served").inc(n)
    reg.counter("serve_batches_total", "bucket dispatches").inc()
    if degraded:
        reg.counter("serve_degraded_total",
                    "dispatches served below the preferred ladder ef").inc()
    reg.histogram("serve_coalesce_size", "requests coalesced per dispatch",
                  buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512)).observe(n)
    reg.histogram("serve_occupancy", "live rows / bucket batch per dispatch",
                  buckets=(0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)
                  ).observe(n / bucket.batch)
    wait_h = reg.histogram("serve_queue_wait_seconds", "arrival -> dispatch (loop clock)")
    lat_h = reg.histogram("serve_latency_seconds", "arrival -> finish (loop clock)")
    miss = reg.counter("serve_deadline_miss_total", "late responses")
    for r in batch:
        wait_h.observe(now - r.arrival_t)
        lat_h.observe(finish - r.arrival_t)
        if finish > r.deadline_t:
            miss.inc()
        reg.event("response", finish, rid=r.rid, latency_s=finish - r.arrival_t,
                  queue_wait_s=now - r.arrival_t, deadline_met=finish <= r.deadline_t)
    reg.event("dispatch", now, batch=bucket.batch, ef=bucket.ef, n=n, degraded=degraded)


def _check_recording(trace, stats, run_reg) -> None:
    """The full-size run's dispatches recorded again two ways, each timed:
    one call a dispatch of the JAX loop's per-response recording
    (``_record_per_response``), and the port's queue and fold.  Both
    registries equal each other and the run's own (less its end gauges)."""
    from repro_torch.launch import serve_loop as sl
    from repro_torch.obs import MetricsRegistry

    by_rid = {r.rid: r for r in trace}
    degraded = {r.rid: r.degraded for r in stats.responses}
    records = [(b.bucket, [by_rid[i] for i in b.rids], b.dispatch_t, b.finish_t,
                degraded[b.rids[0]]) for b in stats.batches]
    plain = MetricsRegistry()
    t0 = time.perf_counter()
    for rec in records:
        _record_per_response(plain, *rec)
    plain_s = time.perf_counter() - t0
    folded = MetricsRegistry()
    loop = sl.ServeLoop.__new__(sl.ServeLoop)
    loop.registry, loop._unfolded = folded, []
    loop.executor = type("Untraced", (), {"last_walk": None})()
    t0 = time.perf_counter()
    for rec in records:
        loop._record_dispatch(*rec)
    loop._fold_dispatches()
    port_s = time.perf_counter() - t0
    run = [m for m in run_reg.collect() if not m["name"].startswith("serve_recompiles")]
    assert plain.collect() == folded.collect() == run, "recording: registries differ"
    assert plain.events == folded.events == run_reg.events, "recording: events differ"
    log(f"obs recording of the run's {len(records)} dispatches ({len(trace)} responses): "
        f"per response (the JAX loop's) {plain_s / len(records) * 1e6:.1f} us a dispatch, "
        f"queued and folded (the port's) {port_s / len(records) * 1e6:.1f} us a dispatch; "
        f"registries, events and the run's own equal")


def phase_observability(loop_runs: dict) -> None:
    """Phase 5d: the observability layer at full size (136,736 x 300
    lognormal).  Traced searches (IpNSW and IpNSWPlus, f32 and int8) equal
    the untraced ones; a traced bucket's replays equal its eager program;
    the full-size loop under the virtual clock bare, with the registry and
    with registry and trace (JAX's obs_overhead protocol: modes interleaved,
    each first in turn, one warm run, the min of the first OBS_JAX_REPEATS
    runs; the min and median of OBS_REPEATS too): the overhead fractions,
    the recording's cost a dispatch (and the JAX loop's) and where the host
    ms goes, equal p50s, no steady build, the served traffic's top-band
    share; the same loop under the wall clock traced beside phase 5b's bare
    run; ``serve --loop --trace --metrics-out`` at the serve default, its
    JSONL read back and rendered by ``repro_torch.obs.report``; a traced
    and an untraced 256 x 40 dispatch profiled."""
    import io

    import numpy as np
    import torch

    from repro_torch.core.brute_force import exact_topk
    from repro_torch.core.ipnsw import IpNSW
    from repro_torch.core.ipnsw_plus import IpNSWPlus
    from repro_torch.data import mips_dataset, mips_queries
    from repro_torch.launch import serve
    from repro_torch.launch import serve_loop as sl
    from repro_torch.launch.serve import _build_ladder, _trace_context
    from repro_torch.launch.serve_loop import schedule_digest
    from repro_torch.obs import MetricsRegistry, load_jsonl, top_band_share
    from repro_torch.obs.report import report

    items = torch.as_tensor(mips_dataset(N_FULL, D_FULL, "lognormal", seed=0), device="cuda")
    queries = mips_queries(LOOP_FULL_REQUESTS, D_FULL, seed=1)
    q256 = torch.as_tensor(queries[:256], device="cuda")
    _zero_counts()
    plus = IpNSWPlus(max_degree=16, ef_construction=32, insert_batch=512).build(items)
    ipnsw = IpNSW(max_degree=16, ef_construction=32, insert_batch=512).build(items)
    for name, index in (("ipnsw", ipnsw), ("ipnsw_plus", plus)):
        ctx = _trace_context(index)
        for storage in ("f32", "int8"):
            _check_traced_search(f"obs search {name} {storage}", index, q256, ctx, storage)
    plus.storage = "f32"

    # the traced buckets: every replay equals the eager traced program
    ladder, ctx = _build_ladder(256, 40), _trace_context(plus)
    traced = sl.BucketExecutor(plus, ladder, k=10, trace_ctx=ctx)
    bare = sl.BucketExecutor(plus, ladder, k=10)
    traced.warmup()
    bare.warmup()
    _check_replays_equal_eager("obs traced buckets f32", traced, queries)

    # the full-size loop under the virtual clock, three ways, interleaved
    trace = sl.poisson_trace(queries, rate_qps=LOOP_FULL_RATE, seed=2, ef=40,
                             classes=("interactive", "standard", "relaxed"))
    modes = {"bare": (bare, False), "metrics": (bare, True), "traced": (traced, True)}

    def serve_once(mode):
        executor, recorded = modes[mode]
        reg = MetricsRegistry() if recorded else None
        executor.registry = reg
        loop = sl.ServeLoop(plus, ladder=ladder, clock=sl.VirtualClock(), executor=executor,
                            service_model=sl.LinearServiceModel(), registry=reg)
        gc.collect()  # set-up: no collection of this phase's garbage in a timed run
        t0 = time.perf_counter()
        with watch_replays() as seen:
            stats = loop.run(trace)
        return time.perf_counter() - t0, stats, reg, seen

    walls = {mode: [] for mode in modes}
    stats_by, regs = {}, {}
    gc.collect()
    gc.freeze()  # the earlier phases' live objects: out of every collection in the runs
    order = list(modes)
    for rep in range(OBS_REPEATS + 1):
        for mode in order[rep % 3:] + order[:rep % 3]:  # each mode first in turn
            wall, stats_by[mode], regs[mode], seen = serve_once(mode)
            _assert_replays(f"obs loop virtual {mode} run {rep}", seen, len(stats_by[mode].batches))
            if rep:
                walls[mode].append(wall)
    gc.unfreeze()
    base, metrics_w, traced_w = (min(walls[m][:OBS_JAX_REPEATS]) for m in modes)
    batches = len(stats_by["bare"].batches)
    p50 = {m: stats_by[m].percentile_ms(50) for m in modes}
    assert p50["bare"] == p50["metrics"] == p50["traced"], f"obs loop: p50 differs {p50}"
    assert schedule_digest(stats_by["bare"].batches) == schedule_digest(stats_by["traced"].batches)
    assert stats_by["traced"].recompiles_steady == 0, "obs loop: a steady build when traced"
    band = regs["traced"].get("walk_evals_by_band").values
    assert band.sum() == regs["traced"].get("walk_evals_total").value > 0
    share = top_band_share(band)
    out = {"base_wall_s": base, "metrics_wall_s": metrics_w, "traced_wall_s": traced_w,
           "metrics_overhead_frac": metrics_w / base - 1.0,
           "traced_overhead_frac": traced_w / base - 1.0,
           "p50_ms_base": p50["bare"], "p50_ms_traced": p50["traced"],
           "recompiles_steady_traced": stats_by["traced"].recompiles_steady,
           "top_band_share": share, "batches": batches,
           "registry_ms_per_dispatch": (metrics_w - base) / batches * 1e3,
           "traced_ms_per_dispatch": (traced_w - base) / batches * 1e3}
    for stat, fn in (("min", min), ("median", np.median)):
        b = float(fn(walls["bare"]))
        out[f"metrics_overhead_frac_{stat}{OBS_REPEATS}"] = float(fn(walls["metrics"])) / b - 1.0
        out[f"traced_overhead_frac_{stat}{OBS_REPEATS}"] = float(fn(walls["traced"])) / b - 1.0
    log(f"obs loop virtual f32 ({LOOP_FULL_REQUESTS} requests, {batches} dispatches; the "
        f"fractions are JAX's protocol, the min of the first {OBS_JAX_REPEATS} runs a mode; walls "
        f"{ {m: ['%.6f' % w for w in ws] for m, ws in walls.items()} }): " + " ".join(
            f"{k}={v!r}" for k, v in out.items())
        + f" (JAX's bar metrics_overhead_frac <= 0.05: "
          f"{'met' if out['metrics_overhead_frac'] <= 0.05 else 'not met'})")
    # where the recording's host time goes: one more run a mode, timed by method
    for mode in ("metrics", "traced"):
        with _timed_methods((sl.ServeLoop, "_record_dispatch"),
                            (sl.ServeLoop, "_fold_dispatches"),
                            (sl.BucketExecutor, "_record_walk"),
                            (sl.BucketExecutor, "run")) as spent:
            wall, stats, _, _ = serve_once(mode)
        log(f"obs loop virtual {mode}: host us a dispatch " + " ".join(
            f"{name}={sec / batches * 1e6:.1f} ({calls} calls)"
            for name, (calls, sec) in spent.items()) + f"; loop wall {wall:.6f} s with timers")
    _check_recording(trace, stats_by["metrics"], regs["metrics"])

    # the full-size loop under the wall clock, traced and recorded
    _, gt = exact_topk(torch.as_tensor(queries, device="cuda"), items, k=10)
    gt = gt.cpu().numpy()
    reg = MetricsRegistry()
    traced.registry = reg
    gc.collect()
    loop = sl.ServeLoop(plus, ladder=ladder, clock=sl.WallClock(), executor=traced,
                        service_model=sl.LinearServiceModel(), registry=reg)
    with watch_replays() as seen:
        stats = loop.run(trace)
    run = _loop_report("wall_f32 traced", stats, gt)
    assert run["served"] == LOOP_FULL_REQUESTS and run["recompiles_steady"] == 0
    _assert_replays("obs loop wall traced", seen, run["batches"])
    bare_run = loop_runs["wall_f32"]
    log(f"obs loop wall f32: traced+registry p50={run['p50_ms']:.4f} p99={run['p99_ms']:.4f} "
        f"qps={run['qps']:.1f} recall={run['recall']:.4f}; phase 5b bare p50="
        f"{bare_run['p50_ms']:.4f} p99={bare_run['p99_ms']:.4f} qps={bare_run['qps']:.1f} "
        f"recall={bare_run['recall']:.4f}; top_band_share="
        f"{top_band_share(reg.get('walk_evals_by_band').values):.4f}")

    # serve --loop --trace --metrics-out at the serve default
    path = ROOT / "build" / "serve_loop_trace.jsonl"
    path.parent.mkdir(exist_ok=True)
    with watch_replays() as seen:
        res = serve.main(["--loop", "--trace", "--metrics-out", str(path)])
    _assert_replays("obs serve --loop --trace", seen, res["summary"]["batches"])
    assert schedule_digest(res["batches"]) == JAX_LOOP_SCHEDULE_SHA256
    assert abs(res["recall"] - JAX_LOOP_RECALL["f32"]) <= RECALL_MARGIN, res["recall"]
    snap = load_jsonl(str(path))
    buf = io.StringIO()
    summary = report(str(path), out=buf)
    assert snap["meta"]["traced"] and summary["serve_requests_total"] == 256
    assert sum(e["event"] == "response" for e in snap["events"]) == 256
    log(f"obs serve --loop --trace --metrics-out {path.relative_to(ROOT)}: "
        f"{path.stat().st_size} bytes, {len(snap['metrics'])} metrics, {len(snap['events'])} "
        f"events; report summary {summary}")
    for line in buf.getvalue().splitlines()[:16]:
        log(f"obs report | {line}")

    # a traced and an untraced dispatch of the full 256 x 40 bucket
    full, host_q, ones = sl.Bucket(256, 40), queries[:256], np.ones(256, bool)
    traced.registry = bare.registry = None
    for label, executor in (("untraced", bare), ("traced", traced)):
        executor.run(full, host_q, ones)
        _profiled(f"obs dispatch of a full 256x40 bucket, f32 [captured, {label}]",
                  lambda: executor.run(full, host_q, ones), batches=1, reps=20)
    counts = _read_counts()
    _assert_path("observability", counts, OBS_PATH)
    log(f"observability: launches={counts} gather_score by width={_widths()['gather_score']} "
        f"quant_score by width={_widths()['quant_score']}")


# kernels whose only path is their own entry point (phase_entry_points)
ENTRY_ONLY = ("topk_merge", "flash_attn", "flash_attn_bf16", *STEP_KERNELS,
              "mips_topk_select_int8")
# kernels whose path is serve --k 33 (phase 4)
K33_PATH = ("mips_topk_select",)
# kernels whose path is LM training (phase 11)
TRAIN_PATH = ("flash_attn_bwd", "flash_attn_bwd_bf16")

# kernels each serving-loop path must launch: the build, the ground truth,
# the walks' steps and seeds (f32: gather_score; int8: quant_score, and
# gather_score for the rerank); under churn the live walks of the searches
# and the upserts, and their commits
LOOP_PATHS = {
    "f32": ([], ("beam_walk", "commit_merge", "mips_topk", "gather_score")),
    "int8": (["--storage", "int8"], ("beam_walk", "beam_walk_int8", "commit_merge",
                                     "mips_topk", "quant_score", "gather_score")),
    "churn": (["--churn-trace", "0.2"], ("beam_walk", "beam_walk_live", "commit_merge",
                                         "mips_topk", "gather_score")),
}


def phase_serve_loop_default() -> None:
    """serve --loop at the JAX CLI's defaults, virtual clock: the schedule,
    the service model's latencies, the churn events and health equal to the
    JAX package's; recall@10 within 0.02 of it."""
    from repro_torch.launch import serve
    from repro_torch.launch.serve_loop import schedule_digest

    for name, (flags, path) in LOOP_PATHS.items():
        _zero_counts()
        t0 = time.perf_counter()
        with watch_replays() as seen:
            res = serve.main(["--loop", *flags])
        wall = time.perf_counter() - t0
        counts = _read_counts()
        s, digest = res["summary"], schedule_digest(res["batches"])
        log(f"serve --loop {name}: recall@10={res['recall']!r} (JAX "
            f"{JAX_LOOP_RECALL[name]!r}) schedule_sha256={digest} summary={s} "
            f"wall_s={wall:.2f} launches={counts}")
        # every dispatch replays its bucket's graph (warmup captured them),
        # and under churn every upsert chunk after the first replays its own
        _assert_replays(f"loop {name}", seen, s["batches"] + (
            LOOP_CHURN_UPSERTS - 1 if name == "churn" else 0))
        assert abs(res["recall"] - JAX_LOOP_RECALL[name]) <= RECALL_MARGIN, \
            f"loop {name} recall {res['recall']} not within {RECALL_MARGIN} of JAX"
        assert digest == JAX_LOOP_SCHEDULE_SHA256, f"loop {name}: the schedule differs from JAX's"
        for key, want in JAX_LOOP_SUMMARY.items():
            assert s[key] == want, f"loop {name}: {key}={s[key]!r}, JAX {want!r}"
        if name == "churn":
            assert s["mutation_events"] == JAX_LOOP_CHURN["mutation_events"], s
            for key in ("health_live_fraction", "health_dead_edge_frac"):
                assert f"{s[key]:.3f}" == f"{JAX_LOOP_CHURN[key]:.3f}", f"loop churn: {key}"
            assert s["health_relink_debt"] == JAX_LOOP_CHURN["health_relink_debt"], s
        else:
            assert s["mutation_events"] == 0, s
        _assert_path(f"loop {name}", counts, path)


# serve --loop --churn-trace 0.2: round(0.2 * 20,000 / 32) upsert events of
# 32 rows, one chunk each at mutation_batch 32
LOOP_CHURN_UPSERTS = 125


def _upsert_chunks(events, mutation_batch: int) -> int:
    return sum(-(-len(ev.items) // mutation_batch) for ev in events if ev.kind == "upsert")


def _assert_replays(label: str, seen: dict, want: int) -> None:
    """``want`` graph replays, every one under sync debug mode "error"."""
    assert seen["replays"] == want and seen["modes"] <= {2}, \
        f"{label}: {seen['replays']} replays under modes {seen['modes']}, expected {want} " \
        f"under sync debug mode 2"
    log(f"{label}: {want} CUDA graph replays, every one under sync debug mode error")


@contextlib.contextmanager
def eager_upserts():
    """Inside, every upsert chunk of a MutableIndex runs eagerly on the card
    (``upsert_step`` on the chunk), not as a replay of its captured graph."""
    from repro_torch.core import mutation

    captured = mutation.MutableIndex._upsert_chunk

    def eager(m, slots, pay, valid):
        mutation.upsert_step(m.index, m.norms, m.live)(slots, pay, valid)

    mutation.MutableIndex._upsert_chunk = eager
    try:
        yield
    finally:
        mutation.MutableIndex._upsert_chunk = captured


def _eager_bucket(executor, bucket, capturable: bool = True):
    """A bucket's search run eagerly: the module-level ``_ipnsw_bucket`` /
    ``_plus_bucket`` that its program captured (traced with the executor's
    trace context, if it has one), over the executor's operands and on the
    buffers its program holds (the latest dispatch's inputs); the packed
    host output (``serve_loop._pack``): ids, score bits, evals and, traced,
    the walk's columns."""
    import functools

    from repro_torch.core.ipnsw_plus import IpNSWPlus
    from repro_torch.launch import serve_loop as sl

    prog, idx = executor._programs[bucket][1], executor.index
    fn = (functools.partial(sl._plus_bucket, ang_ef=idx.ang_ef, k_angular=idx.k_angular)
          if isinstance(idx, IpNSWPlus) else sl._ipnsw_bucket)
    return sl._pack(*fn(*executor._consts(), prog.q_buf, prog.v_buf, k=executor.k,
                        ef=bucket.ef, storage=idx.storage, capturable=capturable,
                        trace=executor.trace_ctx)).cpu().numpy()


def _check_replays_equal_eager(label: str, executor, queries) -> None:
    """Each bucket of the executor's ladder dispatched (one replay, under
    sync debug mode "error") with three pad rows, against the eager program
    on the same buffers: the packed outputs (ids, score bits, evals, and a
    traced program's walk columns) bit-identical, pad rows included."""
    import numpy as np

    for bucket in executor.ladder.buckets():
        valid = np.arange(bucket.batch) < bucket.batch - 3
        with watch_replays() as seen:
            got = executor._programs[bucket][1](
                np.asarray(queries[:bucket.batch], np.float32), valid)
        assert seen == {"replays": 1, "modes": {2}}, f"{label} {bucket}: {seen}"
        want = _eager_bucket(executor, bucket)
        assert got.shape == want.shape and np.array_equal(got, want), \
            f"{label} {bucket}: the replay's packed output differs from the eager program's " \
            f"in columns {sorted(set(np.nonzero(got != want)[1].tolist()))}"
    capture_ms = {f"{b.batch}x{b.ef}": round(executor._programs[b][1].captured.capture_ms, 2)
                  for b in executor.ladder.buckets()}
    log(f"{label}: every bucket's replay (3 pad rows) equals the eager program bit for bit "
        f"({got.shape[1]} packed columns: ids, score bits, evals"
        f"{', band_hist, hub_evals, steps' if executor.trace_ctx is not None else ''}); "
        f"capture_ms={capture_ms}")


# kernels each churn phase must launch: the live walks of upserts, relinks
# and searches (f32 and int8), the commits, the seeds' scorers and the
# ground truth over the live catalog
CHURN_PATH = ("beam_walk_live", "beam_walk_int8_live", "commit_merge", "gather_score",
              "quant_score", "mips_topk")


def _live_ground_truth(queries, m, k: int = 10):
    """Exact top k over the live rows (the mips_topk kernel), as slot ids."""
    import torch

    from repro_torch.core.brute_force import exact_topk

    live_ids = torch.nonzero(m.live).flatten()
    _, pos = exact_topk(queries, m.graph.items[live_ids], k=k)
    return live_ids[pos.long()].cpu().numpy()


def _assert_no_tombstone(m, ids, what: str) -> None:
    hit = (ids >= 0) & ~m.live[ids.clamp_min(0).long()]
    assert not bool(hit.any()), f"{what}: a tombstoned id surfaced"


def _dead_evals(m, res) -> float:
    """Evaluations per query spent on tombstones: the dead ids among the
    scored ids of both ip-NSW+ walks (each scored id is in a visited buffer
    once)."""
    dead = 0
    for vis in (res.visited_ang, res.visited_ip):
        dead = dead + ((vis >= 0) & ~m.live[vis.clamp_min(0).long()]).sum(-1)
    return float(dead.float().mean())


def phase_churn_default() -> dict:
    """The serve default opened for mutation, under the JAX serve CLI's churn
    trace, with a search between events; held to the JAX package's recall
    on the same trace and to a fresh rebuild of the live catalog."""
    import torch

    from repro_torch.core import ChurnTrace, IpNSWPlus, MutableIndex, apply_churn_event
    from repro_torch.core.brute_force import exact_topk
    from repro_torch.data import mips_dataset, mips_queries
    from repro_torch.obs.recall import recall_at_k

    n, d = 20_000, 64
    items = torch.as_tensor(mips_dataset(n, d, "lognormal", seed=0), dtype=torch.float32,
                            device="cuda")
    queries = torch.as_tensor(mips_queries(256, d, seed=1), device="cuda")
    index = IpNSWPlus(max_degree=16, ef_construction=32, insert_batch=512).build(items)
    _zero_counts()
    m = MutableIndex(index, capacity=int(n * 1.25), mutation_batch=32)
    trace = ChurnTrace.generate(n_items=n, dim=d, turnover=0.2, **CHURN)
    recall = {"before": recall_at_k(m.search(queries, k=10, ef=40).ids.cpu().numpy(),
                                    _live_ground_truth(queries, m))}
    with watch_replays() as seen:
        for i, ev in enumerate(trace.events):
            apply_churn_event(m, ev)
            storage = "int8" if i % 16 == 15 else "f32"
            _assert_no_tombstone(m, m.search(queries, k=10, ef=40, storage=storage).ids,
                                 f"search after event {i} ({ev.kind}, {storage})")
    # the first int8 search made the stores after the first upsert: the
    # next upsert captured its chunk again, over them
    _assert_replays("churn default", seen, _upsert_chunks(trace.events, 32) - 2)
    errs = m.check_invariants()
    assert not errs, "invariants I1-I6 after the trace:\n  " + "\n  ".join(errs)
    gt = _live_ground_truth(queries, m)
    for storage in ("f32", "int8"):
        r = m.search(queries, k=10, ef=40, storage=storage)
        _assert_no_tombstone(m, r.ids, f"search after the trace ({storage})")
        recall[f"after_trace_{storage}"] = recall_at_k(r.ids.cpu().numpy(), gt)
    passes = 0
    while m.relink_debt():
        m.relink(64)
        passes += 1
    r = m.search(queries, k=10, ef=40)
    _assert_no_tombstone(m, r.ids, "search after relinking")
    recall["after_relink"] = recall_at_k(r.ids.cpu().numpy(), gt)
    counts = _read_counts()
    live_ids = torch.nonzero(m.live).flatten()
    compact = m.graph.items[live_ids].contiguous()
    fresh = IpNSWPlus(max_degree=16, ef_construction=32, insert_batch=512).build(compact)
    _, gt_f = exact_topk(queries, compact, k=10)
    recall["fresh_rebuild"] = recall_at_k(
        fresh.search(queries, k=10, ef=40).ids.cpu().numpy(), gt_f.cpu().numpy())
    log(f"churn default: N={n} d={d} capacity={m.capacity} events={trace.n_events} "
        f"relink_passes_after_trace={passes} invariants I1-I6 hold, no tombstone surfaced "
        f"recall@10 " + " ".join(f"{k}={v:.4f}" for k, v in recall.items())
        + f" (JAX {JAX_CHURN_RECALL}) health={m.health()} launches={counts}")
    for key in ("after_trace_f32", "after_relink"):
        assert abs(recall[key] - JAX_CHURN_RECALL) <= RECALL_MARGIN, \
            f"churn recall {key}={recall[key]} not within {RECALL_MARGIN} of JAX {JAX_CHURN_RECALL}"
    assert recall["after_relink"] >= recall["fresh_rebuild"] - RECALL_MARGIN, \
        f"churn recall {recall['after_relink']} below a fresh rebuild's {recall['fresh_rebuild']}"
    _assert_path("churn default", counts, CHURN_PATH)
    return counts


def phase_churn_full() -> dict:
    """A mutable IpNSWPlus at Yahoo!Music's size under a churn trace of
    turnover 0.1: the slice's main path at full width."""
    import numpy as np
    import torch

    from repro_torch.core import ChurnTrace, IpNSWPlus, MutableIndex, apply_churn_event
    from repro_torch.data import mips_dataset, mips_queries
    from repro_torch.launch.serve import _build_ladder
    from repro_torch.launch.serve_loop import BucketExecutor
    from repro_torch.obs.recall import recall_at_k

    items = torch.as_tensor(mips_dataset(N_FULL, D_FULL, "lognormal", seed=0), device="cuda")
    queries = torch.as_tensor(mips_queries(256, D_FULL, seed=1), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    index = IpNSWPlus(max_degree=16, ef_construction=32, insert_batch=512).build(items)
    del items
    trace = ChurnTrace.generate(n_items=N_FULL, dim=D_FULL, turnover=0.1, **CHURN)
    phase_upsert_twins(index, trace)
    _zero_counts()
    m = MutableIndex(index, capacity=int(N_FULL * 1.25), mutation_batch=32)
    recall = {}
    gt = _live_ground_truth(queries, m)
    recall["before"] = recall_at_k(m.search(queries, k=10, ef=40).ids.cpu().numpy(), gt)
    recall["before_int8"] = recall_at_k(
        m.search(queries, k=10, ef=40, storage="int8").ids.cpu().numpy(), gt)
    ms = {"upsert": [], "delete": [], "relink": [], "hub_kill": []}
    with watch_replays() as seen:
        for i, ev in enumerate(trace.events):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            apply_churn_event(m, ev)
            torch.cuda.synchronize()
            ms[ev.kind].append((time.perf_counter() - t0) * 1e3)
            if i % 64 == 63:
                _assert_no_tombstone(m, m.search(queries, k=10, ef=40).ids,
                                     f"search after event {i}")
    # the int8 search above made the stores before the first upsert: one capture
    _assert_replays("churn full upserts", seen, _upsert_chunks(trace.events, 32) - 1)
    log(f"churn full: upsert chunk capture_ms={m.upsert_capture_ms:.2f}")
    errs = m.check_invariants()
    assert not errs, "invariants I1-I6 after the trace:\n  " + "\n  ".join(errs)
    for kind, t in ms.items():
        log(f"churn full: {kind} n={len(t)} ms_mean={np.mean(t):.3f} ms_median="
            f"{np.median(t):.3f} ms_max={np.max(t):.3f}")
    # search with and without the tombstone mask, same index, ten pairs in
    # turns (live first in even pairs)
    times = {"live": [], "plain": []}
    for pair in range(10):
        for order in (("live", "plain") if pair % 2 == 0 else ("plain", "live")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if order == "live":
                m.search(queries, k=10, ef=40)
            else:
                m.index.search(queries, k=10, ef=40)
            torch.cuda.synchronize()
            times[order].append((time.perf_counter() - t0) * 1e3)
    log("churn full: search B=256 ef=40 ms " + " ".join(
        f"{name}_median={np.median(t):.3f} {name}={['%.3f' % x for x in t]}"
        for name, t in times.items()))
    gt = _live_ground_truth(queries, m)
    for storage in ("f32", "int8"):
        r = m.search(queries, k=10, ef=40, storage=storage)
        _assert_no_tombstone(m, r.ids, f"search after the trace ({storage})")
        recall[f"after_trace_{storage}"] = recall_at_k(r.ids.cpu().numpy(), gt)
        log(f"churn full: after the trace storage={storage} dead_evals/q={_dead_evals(m, r):.2f} "
            f"evals/q={float(r.evals.float().mean()):.1f}")
    debt0, passes = m.relink_debt(), 0
    t0 = time.perf_counter()
    while passes < RELINK_PASS_CAP and m.relink_debt():
        m.relink(64)
        passes += 1
    torch.cuda.synchronize()
    relink_s = time.perf_counter() - t0
    r = m.search(queries, k=10, ef=40)
    _assert_no_tombstone(m, r.ids, "search after relinking")
    recall["after_relink"] = recall_at_k(r.ids.cpu().numpy(), gt)
    log(f"churn full: relink debt after the trace {debt0}, {passes} passes of 64 in "
        f"{relink_s:.2f} s (cap {RELINK_PASS_CAP}), debt left {m.relink_debt()}; "
        f"after relinking dead_evals/q={_dead_evals(m, r):.2f}")
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()  # the mutable index's, before the rebuild
    live_ids = torch.nonzero(m.live).flatten()
    compact = m.graph.items[live_ids].contiguous()
    t0 = time.perf_counter()
    fresh = IpNSWPlus(max_degree=16, ef_construction=32, insert_batch=512).build(compact)
    torch.cuda.synchronize()
    fresh_s = time.perf_counter() - t0
    pos = fresh.search(queries, k=10, ef=40).ids.long()
    recall["fresh_rebuild"] = recall_at_k(
        torch.where(pos >= 0, live_ids[pos.clamp_min(0)], -1).cpu().numpy(), gt)
    del fresh, compact
    log(f"churn full: fresh rebuild of the live catalog build_s={fresh_s:.2f}")
    log(f"churn full: N={N_FULL} d={D_FULL} capacity={m.capacity} events={trace.n_events} "
        f"recall@10 " + " ".join(f"{k}={v:.4f}" for k, v in recall.items())
        + f" health={m.health()} peak_memory_bytes={peak} "
        f"launches={counts}")
    assert recall["after_relink"] > 0.5, f"churn full recall@10 {recall['after_relink']}"
    _assert_path("churn full", counts, CHURN_PATH)
    executor = BucketExecutor(m, _build_ladder(256, 40), k=10)
    executor.warmup()
    _check_replays_equal_eager("churn full, the live mask", executor,
                               mips_queries(256, D_FULL, seed=1))
    payload = mips_dataset(32, D_FULL, "lognormal", seed=4)
    with eager_upserts():
        _profiled("churn upsert batch of 32 [eager]", lambda: m.upsert(payload), batches=1,
                  reps=20)
    _profiled("churn upsert batch of 32 [captured]", lambda: m.upsert(payload), batches=1,
              reps=20)
    return counts


# the churn prefix that the eager and the captured upsert both take
TWIN_EVENTS = 64


def phase_upsert_twins(index, trace) -> None:
    """Two copies of a built IpNSWPlus (int8 stores made), each opened as a
    MutableIndex, take the trace's first TWIN_EVENTS events: one with
    captured upserts (every chunk after the first a replay under sync debug
    mode "error"), one with eager upserts.  Both graphs, both stores, the
    live mask, the norms and the carries are then bit-identical; ms per
    upsert batch each way."""
    import copy

    import numpy as np
    import torch

    from repro_torch.core import MutableIndex, apply_churn_event

    twins, ms = {}, {}
    for mode in ("captured", "eager"):
        m = MutableIndex(copy.deepcopy(index), capacity=int(N_FULL * 1.25), mutation_batch=32)
        m.index._make_stores("int8")
        ms[mode] = []
        with eager_upserts() if mode == "eager" else watch_replays() as seen:
            for ev in trace.events[:TWIN_EVENTS]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                apply_churn_event(m, ev)
                torch.cuda.synchronize()
                if ev.kind == "upsert":
                    ms[mode].append((time.perf_counter() - t0) * 1e3)
        if mode == "captured":
            _assert_replays("upsert twins, captured", seen,
                            _upsert_chunks(trace.events[:TWIN_EVENTS], 32) - 1)
        twins[mode] = m
    a, b = twins["captured"], twins["eager"]
    fields = {"live": (a.live, b.live), "norms": (a.norms, b.norms)}
    for gname in ("ang_graph", "ip_graph"):
        for field in ("adj", "items", "size", "entry", "entry_norm"):
            fields[f"{gname}.{field}"] = (getattr(getattr(a.index, gname), field),
                                          getattr(getattr(b.index, gname), field))
    for sname in ("ang_store", "ip_store"):
        for field in ("codes", "scales"):
            fields[f"{sname}.{field}"] = (getattr(getattr(a.index, sname), field),
                                          getattr(getattr(b.index, sname), field))
    for name, (x, y) in fields.items():
        assert torch.equal(x, y), f"upsert twins: {name} differs between captured and eager"
    assert a.operands() != b.operands() and a._free == b._free
    log(f"upsert twins: {TWIN_EVENTS} churn events on two copies of the full-size IpNSWPlus "
        f"(int8 stores): captured and eager upserts leave {len(fields)} tensors bit-identical "
        f"(both graphs, both stores, live, norms, entries); capture_ms={a.upsert_capture_ms:.2f} "
        f"ms per upsert batch of 32 captured median={np.median(ms['captured']):.3f} "
        f"{['%.3f' % x for x in ms['captured']]} eager median={np.median(ms['eager']):.3f} "
        f"{['%.3f' % x for x in ms['eager']]}")
    del twins, a, b
    torch.cuda.empty_cache()


def _profiled(label: str, fn, batches: int = 0, reps: int = 0) -> list:
    """Run ``fn`` under torch.profiler; print wall time, the device time
    its kernels took (one stream, so they do not overlap), the idle share,
    the walk steps and the host time per step (per insertion batch, given
    ``batches``), and the top device ops; return the device events.  With
    ``reps``, ``fn`` then runs that many times unprofiled (the profiler
    slows the host, most of all a graph replay, whose every kernel node it
    traces): the median wall, and the idle share and host ms of that wall
    beside the profiled device time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps0 = _walk_steps()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = _walk_steps() - steps0
    # device-side events only: a CPU op's entry repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_s = sum(e.self_device_time_total for e in events) * 1e-6
    # a captured walk keeps its steps on the card: none is counted here
    per_step = (f"walk_steps={steps} host_ms_per_step={(wall - device_s) / steps * 1e3:.4f}"
                if steps else "walk_steps=not read back")
    per_batch = (f" host_ms_per_batch={(wall - device_s) / batches * 1e3:.4f}" if batches
                 else "")
    log(f"profile {label}: wall_s={wall:.3f} device_busy_s={device_s:.3f} "
        f"idle_share={1 - device_s / wall:.3f} {per_step}{per_batch} "
        f"wall_ms={wall * 1e3:.4f} device_busy_ms={device_s * 1e3:.4f}")
    if reps:
        walls = _walls(fn, reps)
        med = float(np.median(walls))
        log(f"profile {label}: unprofiled wall_ms median={med:.4f} of {reps} "
            f"[{min(walls):.4f}, {max(walls):.4f}] idle_share={1 - device_s * 1e3 / med:.3f} "
            f"host_ms={med - device_s * 1e3:.4f}")
    for e in events[:6]:
        log(f"profile {label}: {e.self_device_time_total * 1e-3:10.2f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")
    return events


def _walls(fn, reps: int = 20) -> list:
    """Wall milliseconds of ``reps`` unprofiled calls of ``fn``, the card
    synchronized around each."""
    import torch

    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def _median_ms(fn, reps: int = 20) -> float:
    import numpy as np

    return float(np.median(_walls(fn, reps)))


def _profiled_both(label: str, fn, reps: int = 0) -> None:
    """``_profiled`` with per-step walks (before), then with the fused walk
    (after), in one run."""
    with per_step_walks():
        _profiled(f"{label} [per-step loop]", fn, reps=reps)
    _profiled(label, fn, reps=reps)


@contextlib.contextmanager
def per_step_walks(capturable: bool = False):
    """Inside, every walk of core/search runs as the host loop of the
    beam_step kernel (``per_step_walk``), as the port walked before
    beam_walk.  ``capturable``: a walk asked to read nothing back takes
    the loop too, which reads back every step (outside a capture only)."""
    from repro_torch.core import search

    fused = search.beam_walk
    search.beam_walk = ((lambda *a, capturable=False, **kw: per_step_walk(*a, **kw))
                        if capturable else per_step_walk)
    try:
        yield
    finally:
        search.beam_walk = fused


def phase_profile(items, queries, ipnsw) -> None:
    """Where the time goes at full size (profiler on: the walls here are
    longer than the unprofiled ones above), with per-step walks and with
    the fused walk; the builds with the host and the scan driver.  A scan
    build's walks keep their steps on the card (walk_steps counts none of
    them), and its replayed kernels must show in the trace: each graph's
    walk kernel once a batch.  IpNSW's searches also run as a captured
    256 x 40 bucket."""
    import numpy as np

    from repro_torch.core.build import batch_schedule, replay_schedule
    from repro_torch.core.ipnsw import IpNSW
    from repro_torch.core.ipnsw_plus import IpNSWPlus
    from repro_torch.launch.serve_loop import Bucket, BucketExecutor, BucketLadder

    batches = 1 + batch_schedule(N_FULL, 512)[1].shape[0]
    _profiled_both("ipnsw build", lambda: IpNSW(max_degree=16, ef_construction=32,
                                                insert_batch=512).build(items))
    for name, cls in (("ipnsw", IpNSW), ("ipnsw_plus", IpNSWPlus)):
        for driver in ("host", "scan"):
            want = (batches - 1) * (2 if name == "ipnsw_plus" else 1)
            for _ in range(PROFILER_SESSIONS):  # a session may lose a replay's events
                events = _profiled(
                    f"{name} build [{driver} driver]",
                    lambda: cls(max_degree=16, ef_construction=32, insert_batch=512,
                                build_backend=driver).build(items), batches=batches)
                walks = sum(e.count for e in events if "beam_walk_kernel" in e.key)
                if walks >= want:
                    break
                log(f"profile {name} build [{driver}]: the trace shows {walks} of {want} walk "
                    f"kernels; profiling again")
            assert walks == want, \
                f"profile {name} build [{driver}]: the trace shows {walks} walk kernels"
            if driver == "scan":
                run = replay_schedule.last
                log(f"profile {name} build [scan driver]: capture_ms={run.capture_ms:.2f} "
                    f"replay_loop_device_ms="
                    f"{run.loop_events[0].elapsed_time(run.loop_events[1]):.2f} (CUDA events) "
                    f"host_ms_per_replay={run.loop_host_ms / run.replays:.4f}")
    _profiled_both("ipnsw search", lambda: ipnsw.search(queries, k=10, ef=40), reps=20)
    _profiled_both("ipnsw search int8",
                   lambda: ipnsw.search(queries, k=10, ef=40, storage="int8"), reps=20)
    # the same searches as a captured 256 x 40 bucket
    bucket, host_q, ones = Bucket(256, 40), queries.cpu().numpy(), np.ones(256, bool)
    for storage in ("f32", "int8"):
        ipnsw.storage = storage
        executor = BucketExecutor(ipnsw, BucketLadder(batches=(256,), efs=(40,)), k=10)
        executor.warmup()
        with watch_replays() as seen:
            ids, scores, _ = executor.run(bucket, host_q, ones)
        want = ipnsw.search(queries, k=10, ef=40)
        assert seen["replays"] == 1 and np.array_equal(ids, want.ids.cpu().numpy()) and \
            np.array_equal(scores, want.scores.cpu().numpy()), f"captured search {storage}"
        log(f"ipnsw search {storage} as a captured bucket: ids and scores equal the search's; "
            f"capture_ms={executor._programs[bucket][1].captured.capture_ms:.2f}")
        _profiled(f"ipnsw search {storage} [captured bucket]",
                  lambda: executor.run(bucket, host_q, ones), batches=1, reps=20)
    ipnsw.storage = "f32"


# ------------------------------------------------------------ phase 7: sharded

# `XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu
# PYTHONPATH=src python -m repro.launch.serve --shards 4 ...` (the JAX package,
# on the CPU) printed, with --partition norm_bands --route upper_bound:
# [serve] index=ipnsw_plus shards=4 storage=f32 partition=norm_bands
# route=upper_bound shards_visited_mean=2.09 skipped_mean=1.91 N=20000 B=256
# ef=40: recall@10=0.930 evals/q=1224 (0.73 ms/query batch-amortized)
# xla_compiles=1446
# with --storage tiered added: the same but storage=tiered, evals/q=1225
# (0.70 ms/query batch-amortized) xla_compiles=1535; and with the default
# --partition roundrobin --route none: shards_visited_mean=4.00
# skipped_mean=0.00 recall@10=0.995 evals/q=1949 (0.41 ms/query
# batch-amortized) xla_compiles=968.
SHARDED_SERVE = {  # name: (flags, JAX's recall@10, JAX's shards_visited_mean)
    "norm_bands_upper_bound": (["--partition", "norm_bands", "--route", "upper_bound"],
                               0.930, 2.09),
    "norm_bands_upper_bound_tiered": (["--partition", "norm_bands", "--route", "upper_bound",
                                       "--storage", "tiered"], 0.930, 2.09),
    "roundrobin_none": (["--partition", "roundrobin", "--route", "none"], 0.995, 4.00),
}
SHARDS = 4  # the JAX CLI's example: 34,184 rows a shard at full size
SHARD_BUILD = dict(max_degree=16, ef_construction=32, insert_batch=512)
# beam_walk launches of one sharded search: (plus, routed) -> launches
SHARD_STAGES = {(False, False): 1, (False, True): 2, (True, False): 2, (True, True): 4}
# JAX's routing gate (scripts/check_bench_json.py, check_shard): routed rows
# visit at least 30% fewer shards than round-robin's exhaustive merge, skip
# some, and lose at most 0.01 of its recall@10; asserted at the benchmark's
# CI configuration (benchmarks/shard_bench.py --quick, profile word_like:
# lognormal, N 2,000, d 16, P 8, 32 queries), logged at its full one (N
# 10,000, 256 queries) and at Yahoo!Music's size
ROUTE_RECALL_MARGIN = 0.01
ROUTE_VISITS_SAVED = 0.30
GATE_CELLS = {"ci": (2_000, 32), "full": (10_000, 256)}  # name: (N, queries)
GATE_BUILD = dict(max_degree=16, ef_construction=32, insert_batch=64, build_backend="scan")
# the JAX package's banded-churn scenario scaled to the serve default
# (scripts/sharded_churn_reference.py); the JAX package on the CPU printed
# recall@10 before=0.9453125000000001 after_relink=0.755859375
# fresh_rebuild=0.7898437500000001 (28 relink passes): at this size
# the reference itself ends 0.034 under a fresh rebuild
JAX_SHARDED_CHURN_RECALL = 0.755859375
WALK_KERNELS = ("beam_walk", "beam_walk_int8", "beam_walk_live", "beam_walk_int8_live")
SHARDED_PATH = ("beam_walk", "beam_walk_int8", "beam_walk_live", "commit_merge", "mips_topk",
                "gather_score", "quant_score")


def _walk_launches(fn) -> tuple:
    """(fn's result, its beam_walk launches of every variant, its per-step
    kernel launches)."""
    before = _read_counts()
    out = fn()
    after = _read_counts()
    return (out, sum(after[n] - before[n] for n in WALK_KERNELS),
            sum(after[n] - before[n] for n in STEP_KERNELS))


def _same_graphs(label: str, a, b) -> None:
    """Two ShardedIndexes' graphs bit for bit: adjacency, size, entry,
    entry_norm of every shard, both graphs."""
    import torch

    for name in ("ip", "ang"):
        ga, gb = getattr(a, name), getattr(b, name)
        if ga is None:
            continue
        for field in ("adj", "size", "entry", "entry_norm"):
            x, y = getattr(ga, field), getattr(gb, field)
            same = torch.equal(x.view(torch.int32), y.view(torch.int32)) \
                if x.dtype == torch.float32 else torch.equal(x, y)
            assert same, f"{label}: {name}.{field} differs"


def _check_fanout(label: str, index, queries, plus: bool, storage: str) -> None:
    """The one-launch fan-out against each shard's own walk (beam_search /
    the ip-NSW+ search on the shard's graphs): ids, score bits, evals and
    dead evals equal, row for row."""
    import torch

    from repro_torch.core.distributed import fanout
    from repro_torch.core.ipnsw_plus import _seed_from_angular
    from repro_torch.core.search import beam_search
    from repro_torch.core.storage import ItemStore

    p, b = index.n_shards, queries.shape[0]
    walk = dict(plus=plus, k=10, ef=40, max_steps=80, ang_ef=10, k_angular=10)
    every = torch.arange(p, device=queries.device)
    f, launches, steps = _walk_launches(lambda: fanout(index, queries, every, storage=storage,
                                                       **walk))
    assert launches == (2 if plus else 1) and not steps, \
        f"{label}: the fan-out launched {launches} walks, {steps} per-step kernels"
    int8 = storage == "int8"
    for s in range(p):
        def shard(g):
            return None if g is None else type(g)(g.adj[s], g.items[s], g.size[s], g.entry[s],
                                                  g.entry_norm[s])

        def store(st):
            return None if st is None or not int8 else ItemStore(st.codes[s], st.scales[s])

        live = None if index.live is None else index.live[s]
        if plus:
            a = beam_search(shard(index.ang), queries, index.ang.entry[s].expand(b, 1),
                            pool_size=10, max_steps=20, k=10, storage=storage,
                            store=store(index.ang_store), live=live)
            r = beam_search(shard(index.ip), queries, _seed_from_angular(index.ip.adj[s], a.ids),
                            pool_size=40, max_steps=80, k=10, storage=storage,
                            store=store(index.store), live=live)
            want = (r.ids, r.scores, a.evals + r.evals,
                    None if live is None else a.dead_evals + r.dead_evals)
        else:
            r = beam_search(shard(index.ip), queries, index.ip.entry[s].expand(b, 1),
                            pool_size=40, max_steps=80, k=10, storage=storage,
                            store=store(index.store), live=live)
            want = (r.ids, r.scores, r.evals, r.dead_evals)
        got = (f.ids[s], f.scores[s], f.evals[s],
               None if f.dead_evals is None else f.dead_evals[s])
        assert torch.equal(got[0], want[0]), f"{label}: shard {s} ids"
        assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32)), \
            f"{label}: shard {s} score bits"
        assert torch.equal(got[2], want[2]), f"{label}: shard {s} evals"
        assert (got[3] is None) == (want[3] is None) and (
            got[3] is None or torch.equal(got[3], want[3])), f"{label}: shard {s} dead evals"


def _sharded_timings(label: str, runs: dict, reps: int = 10) -> dict:
    """Median wall ms of each search in ``runs`` (name -> fn), run in turns
    (the order reversed every other round), each call synchronized."""
    import numpy as np
    import torch

    walls = {name: [] for name in runs}
    names = list(runs)
    for i in range(reps):
        for name in (names if i % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    med = {name: float(np.median(w)) for name, w in walls.items()}
    log(f"{label}: search of 256 wall ms, median of {reps} in turns: " + " ".join(
        f"{name}={ms:.4f} [{min(walls[name]):.4f}, {max(walls[name]):.4f}]"
        for name, ms in med.items()))
    return med


def _gate_row(rr_recall: float, rr_stats, nb_recall: float, nb_stats, shards: int) -> dict:
    rr_vis = float(rr_stats.shards_visited.float().mean())
    nb_vis = float(nb_stats.shards_visited.float().mean())
    return {"roundrobin_recall": rr_recall, "roundrobin_visits": rr_vis,
            "recall": nb_recall, "visits": nb_vis, "visited_saved_frac": 1 - nb_vis / rr_vis,
            "skipped_frac": float(nb_stats.bound_skips.float().mean()) / shards}


def _gate_holds(row: dict) -> bool:
    return (row["skipped_frac"] > 0 and row["visited_saved_frac"] >= ROUTE_VISITS_SAVED
            and row["recall"] >= row["roundrobin_recall"] - ROUTE_RECALL_MARGIN)


def _log_gate(label: str, row: dict) -> None:
    log(f"sharded gate {label}: roundrobin recall@10={row['roundrobin_recall']:.4f} "
        f"visits={row['roundrobin_visits']:.4f}; norm_bands upper_bound (oracle) "
        f"recall@10={row['recall']:.4f} visits={row['visits']:.4f} visited_saved_frac="
        f"{row['visited_saved_frac']:.4f} skipped_frac={row['skipped_frac']:.4f} -- JAX's gate "
        f"(>= {ROUTE_VISITS_SAVED} saved, recall within {ROUTE_RECALL_MARGIN}) "
        f"{'holds' if _gate_holds(row) else 'does not hold'}")


def phase_sharded_gate() -> None:
    """JAX's routing gate at the shard benchmark's configurations
    (benchmarks/shard_bench.py, profile word_like), both index kinds, the
    oracle's rows as the benchmark counts them (the fan-out's visits
    beside): asserted at the CI one, logged at the full one."""
    import numpy as np
    import torch

    from repro_torch.core.distributed import (
        build_sharded,
        sharded_search,
        sharded_search_reference,
    )
    from repro_torch.data import mips_dataset, mips_queries
    from repro_torch.obs.recall import recall_at_k

    p, d = 8, 16
    for cell, (n, n_queries) in GATE_CELLS.items():
        items = mips_dataset(n, d, "lognormal", seed=1)
        queries = torch.as_tensor(mips_queries(n_queries, d, seed=100), device="cuda")
        gt = np.argsort(-(queries.cpu().numpy() @ items.T), axis=1, kind="stable")[:, :10]
        for plus in (False, True):
            name = f"{cell} {'ipnsw_plus' if plus else 'ipnsw'} N={n} d={d} P={p}"
            rr = build_sharded(items, p, plus=plus, partition="roundrobin", **GATE_BUILD)
            nb = build_sharded(items, p, plus=plus, partition="norm_bands", storage="int8",
                               **GATE_BUILD)
            common = dict(k=10, ef=32, plus=plus, return_stats=True)
            base = sharded_search_reference(rr, queries, **common)
            for storage in ("f32", "tiered"):
                ids, _, _, st = sharded_search_reference(nb, queries, route="upper_bound",
                                                         storage=storage, **common)
                fan = sharded_search(nb, queries, route="upper_bound", storage=storage,
                                     **common)[3]
                row = _gate_row(recall_at_k(base[0].cpu().numpy(), gt), base[3],
                                recall_at_k(ids.cpu().numpy(), gt), st, p)
                _log_gate(f"{name} {storage} (fan-out visits "
                          f"{float(fan.shards_visited.float().mean()):.4f})", row)
                if cell == "ci":
                    assert _gate_holds(row), f"sharded gate {name} {storage}: {row}"


def phase_sharded_full() -> None:
    """Phase 7 at full size: sharded builds (roundrobin; norm_bands with
    the host and the scan driver, bit-identical), the fan-out against
    each shard's own walk, the fan-out and the oracle merged, routing held
    to the exhaustive merge and to JAX's gate, launches a stage, timings
    and one profiled search."""
    import torch

    from repro_torch.core.brute_force import exact_topk
    from repro_torch.core.capture import no_sync
    from repro_torch.core.distributed import (
        build_sharded,
        sharded_search,
        sharded_search_reference,
    )
    from repro_torch.core.ipnsw import IpNSW
    from repro_torch.data import mips_dataset, mips_queries
    from repro_torch.obs.recall import recall_at_k
    from repro_torch.testing import near_tie_rows

    items = torch.as_tensor(mips_dataset(N_FULL, D_FULL, "lognormal", seed=0), device="cuda")
    queries = torch.as_tensor(mips_queries(256, D_FULL, seed=1), device="cuda")
    _, gt = exact_topk(queries, items, k=10)
    gt = gt.cpu().numpy()
    recall = lambda ids: recall_at_k(ids.cpu().numpy(), gt)  # noqa: E731
    gate, searched = {}, {}
    for plus in (False, True):
        name = "ipnsw_plus" if plus else "ipnsw"
        built, build_s = {}, {}
        for key, partition, driver in (("roundrobin", "roundrobin", "host"),
                                       ("norm_bands", "norm_bands", "host"),
                                       ("norm_bands_scan", "norm_bands", "scan")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            built[key] = build_sharded(items, SHARDS, plus=plus, partition=partition,
                                       build_backend=driver, storage="int8", **SHARD_BUILD)
            torch.cuda.synchronize()
            build_s[key] = time.perf_counter() - t0
            if driver == "scan":
                log(f"sharded {name} scan build: capture ms a shard " + " ".join(
                    f"{run.capture_ms:.2f}" for run in build_sharded.last)
                    + f", replays a shard {[run.replays for run in build_sharded.last]}")
        _same_graphs(f"sharded {name} scan vs host driver", built["norm_bands_scan"],
                     built["norm_bands"])
        log(f"sharded {name}: P={SHARDS} Nloc={built['norm_bands'].ip.adj.shape[1]} build_s "
            + " ".join(f"{k}={v:.3f}" for k, v in build_s.items())
            + " -- the scan driver's graphs equal the host driver's bit for bit; "
            f"max_norm norm_bands={built['norm_bands'].max_norm.tolist()} "
            f"roundrobin={built['roundrobin'].max_norm.tolist()}")
        index = built["norm_bands"]
        common = dict(k=10, ef=40, plus=plus, return_stats=True)
        for storage in ("f32", "int8"):
            label = f"sharded {name} {storage}"
            _check_fanout(label, index, queries, plus, storage)
            (ids_x, sc_x, ev_x, st_x), walks, steps = _walk_launches(
                lambda: sharded_search(index, queries, storage=storage, **common))
            assert walks == SHARD_STAGES[plus, False] and not steps, \
                f"{label}: an unrouted search launched {walks} walks, {steps} per-step kernels"
            ids_o, sc_o, ev_o, _ = sharded_search_reference(index, queries, storage=storage,
                                                            **common)
            assert torch.equal(ids_x, ids_o) and torch.equal(
                sc_x.view(torch.int32), sc_o.view(torch.int32)) and torch.equal(ev_x, ev_o), \
                f"{label}: the fan-out's merge differs from the oracle's"
            base = recall(ids_x)
            runs = {"exhaustive": (ids_x, sc_x, st_x)}
            for tier in ((storage, "tiered") if storage == "f32" else (storage,)):
                (ids_r, sc_r, _, st_r), walks, steps = _walk_launches(
                    lambda: sharded_search(index, queries, storage=tier, route="upper_bound",
                                           **common))
                assert walks == SHARD_STAGES[plus, True] and not steps, \
                    f"{label}: a routed search ({tier}) launched {walks} walks, {steps} per-step"
                ids_s, sc_s, _, st_s = sharded_search_reference(
                    index, queries, storage=tier, route="upper_bound", **common)
                runs[f"routed_{tier}"] = (ids_r, sc_r, st_r)
                runs[f"oracle_{tier}"] = (ids_s, sc_s, st_s)
                assert bool((st_s.shards_visited <= st_r.shards_visited).all()), \
                    f"{label}: the oracle visited more shards than the fan-out ({tier})"
                tied = near_tie_rows(ids_r.cpu().numpy(), ids_s.cpu().numpy(),
                                     sc_r.cpu().numpy(), sc_s.cpu().numpy())
                if tier != "tiered":
                    tied = set(tied) | set(near_tie_rows(ids_r.cpu().numpy(),
                                                         ids_x.cpu().numpy(),
                                                         sc_r.cpu().numpy(),
                                                         sc_x.cpu().numpy()))
                log(f"{label}: routed {tier}: near-tie rows {sorted(tied)}")
            for key, (ids, _, st) in runs.items():
                rec = recall(ids)
                assert int(ids.max()) < N_FULL, f"{label} {key}: an id >= N"
                assert rec >= base - ROUTE_RECALL_MARGIN, \
                    f"{label} {key}: recall {rec} below the exhaustive merge's {base} - 0.01"
                log(f"{label} {key}: recall@10={rec:.4f} shards_visited_mean="
                    f"{float(st.shards_visited.float().mean()):.4f} skipped_mean="
                    f"{float(st.bound_skips.float().mean()):.4f}")
            searched[name, storage] = runs
            # the fan-out reads nothing back: a sync in it raises here
            with no_sync():
                for tier in ((storage, "tiered") if storage == "f32" else (storage,)):
                    sharded_search(index, queries, storage=tier, route="upper_bound", **common)
                sharded_search(index, queries, storage=storage, **common)
        rr = sharded_search_reference(built["roundrobin"], queries, **common)
        oracle = searched[name, "f32"]["oracle_f32"]
        gate[name] = _gate_row(recall(rr[0]), rr[3], recall(oracle[0]), oracle[2], SHARDS)
        del built

    # timings in turns and one profiled search: ip-NSW on the f32 items
    index = build_sharded(items, SHARDS, plus=False, partition="norm_bands",
                          build_backend="scan", **SHARD_BUILD)
    flat = IpNSW(build_backend="scan", **SHARD_BUILD).build(items)
    common = dict(k=10, ef=40, plus=False)
    _sharded_timings("sharded ipnsw f32", {
        "fanout_routed": lambda: sharded_search(index, queries, route="upper_bound", **common),
        "oracle_routed": lambda: sharded_search_reference(index, queries, route="upper_bound",
                                                          **common),
        "fanout_exhaustive": lambda: sharded_search(index, queries, **common),
        "oracle_exhaustive": lambda: sharded_search_reference(index, queries, **common),
        "unsharded": lambda: flat.search(queries, k=10, ef=40),
    })
    _profiled("sharded ipnsw search f32 [routed fan-out]",
              lambda: sharded_search(index, queries, route="upper_bound", **common), reps=20)
    _profiled("sharded ipnsw search f32 [exhaustive fan-out]",
              lambda: sharded_search(index, queries, **common), reps=20)
    for name, row in gate.items():
        _log_gate(f"full size {name}", row)
        # what routing guarantees at any size: it skips, and (above) costs no
        # recall against the exhaustive merge of the same bands
        assert row["skipped_frac"] > 0 and row["visited_saved_frac"] > 0, \
            f"sharded full size {name}: routing skipped no shard"


@contextlib.contextmanager
def counted_upserts():
    """Inside, every upsert chunk of a MutableIndex is counted."""
    from repro_torch.core import mutation

    seen = {"chunks": 0}
    chunk = mutation.MutableIndex._upsert_chunk

    def counted(m, *args):
        seen["chunks"] += 1
        chunk(m, *args)

    mutation.MutableIndex._upsert_chunk = counted
    try:
        yield seen
    finally:
        mutation.MutableIndex._upsert_chunk = chunk


def phase_sharded_churn() -> None:
    """Phase 7 under churn at the serve default (N 20,000, d 64, P 4,
    ip-NSW): the JAX package's banded-churn scenario
    (tests/test_mutation.py::test_sharded_banded_churn_keeps_invariants_and_recall)
    scaled up: delete a third, upsert items whose outliers widen band 0,
    kill band 0's hubs, relink to zero debt."""
    import numpy as np
    import torch

    from repro_torch.core.distributed import (
        ShardedMutable,
        build_sharded,
        sharded_search,
        sharded_search_reference,
    )
    from repro_torch.data import mips_dataset, mips_queries
    from repro_torch.obs.recall import recall_at_k

    n, d, p = 20_000, 64, SHARDS
    items = mips_dataset(n, d, "lognormal", seed=0)
    queries = torch.as_tensor(mips_queries(256, d, seed=77), device="cuda")
    t0 = time.perf_counter()
    sm = ShardedMutable(items, p, plus=False, headroom=-(-n // p), **SHARD_BUILD)
    log(f"sharded churn: N={n} d={d} P={p} capacity={sm.capacity} built in "
        f"{time.perf_counter() - t0:.3f} s")
    assert sm.check_invariants() == []
    common = dict(k=10, ef=64, plus=False, route="upper_bound", return_stats=True)

    def live_recall(ids) -> float:
        gids, live_items = sm.live_items()
        rows = np.argsort(-(queries.cpu().numpy() @ live_items.T), axis=1, kind="stable")[:, :10]
        return recall_at_k(ids.cpu().numpy(), gids[rows])

    base = live_recall(sharded_search_reference(sm.snapshot(), queries, **common)[0])
    rng = np.random.default_rng(3)
    with counted_upserts() as seen, watch_replays() as replays:
        t0 = time.perf_counter()
        sm.delete(rng.choice(sm.live_gids(), size=n * 80 // 256, replace=False))
        t_delete = time.perf_counter() - t0
        fresh_items = mips_dataset(n * 96 // 256, d, "lognormal", seed=8).copy()
        fresh_items[: len(fresh_items) // 24] *= 10.0  # norm outliers: band 0 widens
        t0 = time.perf_counter()
        new_gids = sm.upsert(fresh_items)
        t_upsert = time.perf_counter() - t0
        assert sm.check_invariants() == [] and len(set(new_gids.tolist())) == len(new_gids)
        killed = sm.kill_hubs(0, k=sm.capacity)
        assert len(killed) > 0 and sm.check_invariants() == []
        t0 = time.perf_counter()
        passes = 0
        while sm.relink_debt():
            sm.relink(64)
            passes += 1
        t_relink = time.perf_counter() - t0
    captures = sum(m._upsert_graph is not None for m in sm.shards)
    _assert_replays("sharded churn upserts", replays, seen["chunks"] - captures)
    assert sm.check_invariants() == [], "sharded churn: invariants after relinking"
    snap = sm.snapshot()
    # the routing bound survives churn (the JAX test's check, its 1e-5 too)
    norms = np.linalg.norm(snap.ip.items.cpu().numpy(), axis=-1)
    live = snap.live.cpu().numpy()
    for s in range(p):
        if live[s].any():
            assert norms[s][live[s]].max() <= float(snap.max_norm[s]) + 1e-5, \
                f"sharded churn: band {s} holds a live norm above its max_norm"
    _check_fanout("sharded churn snapshot", snap, queries, False, "f32")
    ids_o, _, _, st_o = sharded_search_reference(snap, queries, **common)
    ids_f, _, _, st_f = sharded_search(snap, queries, **common)
    live_gids = set(sm.live_gids().tolist())
    for ids in (ids_f, ids_o):
        served = set(ids.flatten().tolist()) - {-1}
        assert served <= live_gids, "sharded churn: a tombstoned gid was served"
    rec_post = live_recall(ids_o)
    gids, live_items = sm.live_items()
    fresh = build_sharded(live_items, p, plus=False, partition="norm_bands", **SHARD_BUILD)
    ids_fr = sharded_search_reference(fresh, queries, **common)[0]
    rows = np.argsort(-(queries.cpu().numpy() @ live_items.T), axis=1, kind="stable")[:, :10]
    rec_fresh = recall_at_k(ids_fr.cpu().numpy(), rows)
    log(f"sharded churn: deleted {n * 80 // 256} in {t_delete:.3f} s, upserted {len(new_gids)} in "
        f"{t_upsert:.3f} s ({seen['chunks']} chunks, {captures} captures), killed "
        f"{len(killed)} band-0 hubs, relinked in {passes} passes {t_relink:.3f} s; "
        f"max_norm={snap.max_norm.tolist()} recall@10 before={base:.4f} after_relink="
        f"{rec_post:.4f} (JAX {JAX_SHARDED_CHURN_RECALL}; fan-out {live_recall(ids_f):.4f}) "
        f"fresh_rebuild={rec_fresh:.4f} "
        f"shards_visited_mean={float(st_f.shards_visited.float().mean()):.4f} (oracle "
        f"{float(st_o.shards_visited.float().mean()):.4f}) invariants I1-I6 hold, no "
        f"tombstoned gid served")
    assert abs(rec_post - JAX_SHARDED_CHURN_RECALL) <= RECALL_MARGIN, \
        f"sharded churn: recall {rec_post} not within 0.02 of JAX's {JAX_SHARDED_CHURN_RECALL}"


def phase_sharded_serve() -> None:
    """``serve --shards 4`` at the serve default against the JAX CLI."""
    from repro_torch.launch import serve

    for name, (flags, jax_recall, jax_visited) in SHARDED_SERVE.items():
        res = serve.main(["--index", "ipnsw_plus", "--shards", str(SHARDS), *flags])
        log(f"serve --shards {SHARDS} {name}: recall@10={res['recall']:.4f} (JAX {jax_recall}) "
            f"shards_visited_mean={res['shards_visited_mean']:.4f} (JAX {jax_visited}) "
            f"skipped_mean={res['skipped_mean']:.4f} evals/q={res['evals_per_query']:.1f} "
            f"search_ms={res['search_seconds'] * 1e3:.3f}")
        assert abs(res["recall"] - jax_recall) <= RECALL_MARGIN, \
            f"serve --shards {name}: recall {res['recall']} not within 0.02 of JAX {jax_recall}"


def phase_sharded() -> dict:
    """Phase 7: the sharded path; returns its launches."""
    import torch

    _zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    phase_sharded_full()
    log(f"sharded full size peak_memory_bytes={torch.cuda.max_memory_allocated()}")
    phase_sharded_gate()
    phase_sharded_churn()
    phase_sharded_serve()
    counts = _read_counts()
    log(f"sharded phase: {time.perf_counter() - t0:.1f} s launches={counts}")
    _assert_path("sharded", counts, SHARDED_PATH)
    return counts


# ------------------------------------------------------------ index family

# the serve CLI's build knobs, at full size and at the serve default
FAMILY_BUILD = dict(max_degree=16, ef_construction=32, insert_batch=512)
FAMILY_EF, FAMILY_KEEP = 40, 0.25
LSH_BITS = 96                 # benchmarks/fig7_recall_time.py's width
LSH_CANDIDATES = (100, 800)
SIGN_TOL = 1e-5               # |projection| under which a code's sign is the rounding's
# `PYTHONPATH=src python scripts/index_family_reference.py` (the JAX package, on
# the CPU) printed: [index_family_reference] package=jax N=20000 d=64 B=256 ef=40
# hnsw_levels=[20000, 1261, 81, 4] norm_filter_bound=1.0 ...
# recall@10 hnsw_f32=0.9140625000000001 hnsw_int8=0.9136718750000001
# norm_filter_f32=0.9312500000000001 norm_filter_int8=0.9328125000000002
# lsh_t100=0.38984375 lsh_t800=0.637109375
JAX_FAMILY_RECALL = {"hnsw_f32": 0.9140625000000001, "hnsw_int8": 0.9136718750000001,
                     "norm_filter_f32": 0.9312500000000001,
                     "norm_filter_int8": 0.9328125000000002}
# SimpleLSH draws its planes with each package's own generator, so one draw
# of the port's is not one of JAX's: the card is held to the port's own
# recall on the CPU for plane seeds 0-9 (the same planes), and the mean over
# those seeds to JAX's mean.  `... index_family_reference.py --lsh-seeds 10`
# printed, JAX: lsh_t100 mean=0.38046875 std=0.014155 (seed 0: 0.38984375),
# lsh_t800 mean=0.62125 std=0.017215 (seed 0: 0.637109375); and with
# `--package torch --device cpu` the port's values below (std 0.027917 and
# 0.031039).  The standard error of the difference of the two means is about
# 0.010 and 0.011, so LSH_RECALL_MARGIN is 4.5 of them or more.
JAX_LSH_MEAN_RECALL = {"lsh_t100": 0.38046875, "lsh_t800": 0.62125}
PORT_CPU_LSH_RECALL = {
    "lsh_t100": (0.439453125, 0.40664062500000003, 0.386328125, 0.402734375, 0.367578125,
                 0.36757812500000003, 0.38515625, 0.44375, 0.380078125, 0.4242187499999999),
    "lsh_t800": (0.683203125, 0.6421874999999999, 0.623046875, 0.623046875, 0.609375,
                 0.61640625, 0.615625, 0.68125, 0.60859375, 0.678515625)}
LSH_RECALL_MARGIN = 0.05
# the card against the port's CPU copy, per seed: two of 256 x 10 result slots,
# a near tie at the 10th place of two rows (the rerank's fp32 sums differ in
# order between the card and the CPU)
LSH_CPU_TOL = 2 / 2560
FAMILY_PATH = ("beam_walk", "beam_walk_int8", "commit_merge", "mips_topk", "mips_topk_select",
               "gather_score", "quant_score")
# the plain build of a small hierarchy on integer items: levels of 3,000, 188,
# 12 and 2 items (assign_levels, seed 0), the two top ones under a batch and
# the top one under M 8
FAMILY_PLAIN_N = 3_000


def _device_ms_or_none(fn, only: str = ""):
    """``device_ms``, or None where the profiler keeps losing a call's
    device events (late in a long run it has: 17 of 20 launches seen in
    every session); the CUDA-event times beside it stand."""
    try:
        return device_ms(fn, only=only)
    except RuntimeError as err:
        log(f"device time not measured: {err}")
        return None


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def _timed_build(make):
    """(index, build seconds, graph replays and their sync debug modes)."""
    import torch

    with watch_replays() as seen:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = make()
        torch.cuda.synchronize()
    return index, time.perf_counter() - t0, seen


def _scan_replays(sizes, insert_batch: int) -> int:
    """Graph replays of a scan build over levels of these sizes: rows 1 ..
    T-1 of each schedule of two rows or more."""
    from repro_torch.core.build import batch_schedule

    rows = [batch_schedule(n, insert_batch)[1].shape[0] for n in sizes]
    return sum(r - 1 for r in rows if r >= 2)


def _same_levels(label: str, a, b) -> None:
    """Two HierarchicalIpNSWs level for level, bit for bit: adjacency, size,
    entry, entry_norm, ids and inv (``b`` may lie on another device)."""
    import torch

    assert len(a.levels) == len(b.levels), f"{label}: {len(a.levels)} != {len(b.levels)} levels"
    for level, (x, y) in enumerate(zip(a.levels, b.levels)):
        for field in ("adj", "size", "entry", "entry_norm"):
            u, v = getattr(x, field), getattr(y, field).to(getattr(x, field).device)
            assert torch.equal(u.view(torch.int32) if u.dtype == torch.float32 else u,
                               v.view(torch.int32) if v.dtype == torch.float32 else v), \
                f"{label} level {level}: {field} differs"
        assert torch.equal(a.ids[level], b.ids[level].to(a.ids[level].device)), \
            f"{label} level {level}: ids differ"
        assert torch.equal(a.inv[level], b.inv[level].to(a.inv[level].device)), \
            f"{label} level {level}: inv differs"


def phase_family_hnsw(items, queries, gt, flat) -> dict:
    """HierarchicalIpNSW at full size: built with both drivers, every level
    bit-identical and I1-I4 on it; searched f32 and int8, one beam_walk
    launch a level.  Returns its searches for the per-step check."""
    from repro_torch.core import HierarchicalIpNSW
    from repro_torch.core.invariants import assert_graph_invariants
    from repro_torch.obs.recall import recall_at_k

    built, build_s = {}, {"host": [], "scan": []}
    for driver in ("host", "scan", "scan", "host"):  # in turns
        index, seconds, seen = _timed_build(
            lambda: HierarchicalIpNSW(build_backend=driver, **FAMILY_BUILD).build(items))
        built.setdefault(driver, (index, seconds, seen))
        build_s[driver].append(seconds)
    host, scan = built["host"][0], built["scan"][0]
    sizes = [int(g.size) for g in host.levels]
    assert sizes[0] == N_FULL and sizes == sorted(sizes, reverse=True), sizes
    _same_levels("hnsw host against scan", host, scan)
    for level, graph in enumerate(host.levels):
        assert_graph_invariants(graph, name=f"hnsw/level{level}")
    want = _scan_replays(sizes, FAMILY_BUILD["insert_batch"])
    assert built["scan"][2] == {"replays": want, "modes": {2}}, (built["scan"][2], want)
    assert built["host"][2]["replays"] == 0
    log(f"index family hnsw: N={N_FULL} d={D_FULL} M=16 ef_construction=32 insert_batch=512 "
        f"level_sizes={sizes} upper levels M=8 ef_construction=8; build_s (turns host, scan, "
        f"scan, host) host={['%.4f' % x for x in build_s['host']]} "
        f"scan={['%.4f' % x for x in build_s['scan']]} (scan: {want} graph replays under "
        f"sync debug mode error); every level's adj, size, entry, entry_norm, ids, inv "
        f"bit-identical across the drivers; invariants I1-I4 hold on every level")
    searched = {}
    for storage in ("f32", "int8"):
        run = lambda: host.search(queries, k=10, ef=FAMILY_EF, storage=storage)  # noqa: E731
        run()  # warm-up (int8: the stores)
        res, walks, steps = _walk_launches(run)
        assert walks == len(sizes) and steps == 0, \
            f"hnsw {storage}: {walks} walk launches for {len(sizes)} levels, {steps} per-step"
        rec = recall_at_k(res.ids.cpu().numpy(), gt)
        with uncounted():  # timings and the flat index beside it
            ms = _median_ms(run)
            flat_run = lambda: flat["ipnsw"].search(queries, k=10, ef=FAMILY_EF,  # noqa: E731
                                                    storage=storage)
            flat_res = flat_run()
            flat_rec = recall_at_k(flat_res.ids.cpu().numpy(), gt)
            flat_ms = _median_ms(flat_run)
            if storage == "f32":  # where the time goes: device busy, idle, top kernels
                _profiled("index family hnsw search f32 256x40", run, reps=20)
                _profiled("index family flat ipnsw search f32 256x40", flat_run, reps=20)
        log(f"index family hnsw search storage={storage} B=256 k=10 ef={FAMILY_EF}: "
            f"recall@10={rec:.4f} evals/q={res.evals.float().mean().item():.1f} (descent and "
            f"level 0) ms={ms:.4f} (median of 20) beam_walk launches a search={walks}; flat "
            f"ipnsw recall@10={flat_rec:.4f} evals/q={flat_res.evals.float().mean().item():.1f} "
            f"ms={flat_ms:.4f}")
        assert rec > 0.5, f"hnsw {storage}: recall@10 {rec}"
        searched[storage] = (host, res)
    return searched


def phase_family_norm_filter(items, queries, gt, flat) -> None:
    """NormFilteredIndex(keep_frac=0.25, plus=True) at full size, f32 and
    int8: every id in the kept slice; recall beside its bound and the flat
    IpNSWPlus's."""
    import numpy as np
    import torch

    from repro_torch.core import NormFilteredIndex
    from repro_torch.core.norms import top_group_share
    from repro_torch.obs.recall import recall_at_k

    nf, build_s, _ = _timed_build(lambda: NormFilteredIndex(keep_frac=FAMILY_KEEP, plus=True,
                                                            **FAMILY_BUILD).build(items))
    assert len(nf.global_ids) == int(N_FULL * FAMILY_KEEP)
    share = top_group_share(gt, np.linalg.norm(items.cpu().numpy(), axis=1), 100 * FAMILY_KEEP)
    for storage in ("f32", "int8"):
        run = lambda: nf.search(queries, k=10, ef=FAMILY_EF, storage=storage)  # noqa: E731
        res = run()
        ids = res.ids[res.ids >= 0]
        assert bool(torch.isin(ids, nf.global_ids).all()), f"norm filter {storage}: an id outside"
        rec = recall_at_k(res.ids.cpu().numpy(), gt)
        with uncounted():
            ms = _median_ms(run)
            plus_run = lambda: flat["ipnsw_plus"].search(queries, k=10,  # noqa: E731
                                                         ef=FAMILY_EF, storage=storage)
            plus_rec = recall_at_k(plus_run().ids.cpu().numpy(), gt)
            plus_ms = _median_ms(plus_run)
        log(f"index family norm_filter keep_frac={FAMILY_KEEP} plus=True storage={storage}: "
            f"kept={len(nf.global_ids)} recall@10={rec:.4f} bound top_group_share(gt, 25%)="
            f"{share:.4f} evals/q={res.evals.float().mean().item():.1f} build_s={build_s:.4f} "
            f"ms={ms:.4f} (median of 20); flat ipnsw_plus recall@10={plus_rec:.4f} build_s="
            f"{flat['ipnsw_plus_build_s']:.4f} ms={plus_ms:.4f}; every id in the kept slice")
        assert rec > 0.6 * share, f"norm filter {storage}: recall {rec} under 0.6 x {share}"


def phase_family_lsh(items, queries, gt) -> None:
    """SimpleLSH(n_bits=96) at full size, T = 100 and 800: recall and ms;
    the Hamming stage (mips_topk's select route under bulk ties) bit-
    identical to its plain version on CPU copies of the query codes and
    codes, timed, candidates per row; codes and the whole search against
    the same index copied to the CPU.  Only the searches are counted."""
    import torch

    from repro_torch.core import SimpleLSH
    from repro_torch.core.lsh import augment_items, augment_queries, sign_codes
    from repro_torch.kernels.mips_topk import mips_topk, mips_topk_select
    from repro_torch.kernels.mips_topk.ops import select_plan
    from repro_torch.kernels.mips_topk.ops import launch_cost as mips_launch_cost
    from repro_torch.obs.recall import recall_at_k
    from repro_torch.testing import assert_topk_match

    lsh, build_s, _ = _timed_build(lambda: SimpleLSH(n_bits=LSH_BITS).build(items))
    cpu = SimpleLSH(n_bits=LSH_BITS, device="cpu")
    cpu.codes, cpu.planes, cpu.items = lsh.codes.cpu(), lsh.planes.cpu(), lsh.items.cpu()
    q_cpu = queries.cpu()
    q_codes = sign_codes(augment_queries(queries), lsh.planes)
    planes64 = cpu.planes.double()
    for name, aug, codes in (("item", augment_items(cpu.items), cpu.codes),
                             ("query", augment_queries(q_cpu), q_codes)):
        differ = sign_codes(aug, cpu.planes) != codes.cpu()
        near = (aug.double() @ planes64).abs() < SIGN_TOL
        assert not bool((differ & ~near).any()), f"lsh: {name} codes differ off the sign tolerance"
        log(f"index family lsh {name} codes: card against CPU differ at {int(differ.sum())} of "
            f"{differ.numel()} bits, projections within {SIGN_TOL} of 0: {int(near.sum())}")
    n = lsh.codes.shape[0]
    recalls = []
    for t in LSH_CANDIDATES:
        run = lambda: lsh.search(queries, k=10, n_candidates=t)  # noqa: E731
        res = run()
        rec = recall_at_k(res.ids.cpu().numpy(), gt)
        recalls.append(rec)
        with uncounted():  # the comparisons with the plain versions and the timings
            ms = _median_ms(run)
            hamming = lambda: mips_topk(q_codes, lsh.codes, k=t)  # noqa: E731
            s_k, i_k = hamming()
            s_p, i_p = mips_topk(q_codes.cpu(), cpu.codes, k=t)  # the plain version
            assert torch.equal(i_k.cpu(), i_p) and torch.equal(s_k.cpu(), s_p), \
                f"lsh T={t}: the Hamming stage differs from its plain version"
            kth = s_p[:, -1:]
            split = ((q_codes.cpu() @ cpu.codes.T == kth).sum(1) > (s_p == kth).sum(1))
            cands = mips_topk_select(q_codes, lsh.codes, k=t)[2].float()
            b, d = q_codes.shape
            flops, nbytes = mips_launch_cost(b, n, d, t)
            bound_ms, by = bound(nbytes, flops)
            # by CUDA events: the library call's gemm kernel varies between
            # calls, so device_ms cannot count it a call
            call_ms = cuda_ms(hamming)
            library_call_ms = cuda_ms(lambda: torch.topk(q_codes @ lsh.codes.T, t, dim=1))
            hamming_ms = _device_ms_or_none(hamming)
            select_ms = _device_ms_or_none(hamming, only="select")
        plain = cpu.search(q_cpu, k=10, n_candidates=t)
        same = (q_codes.cpu() == sign_codes(augment_queries(q_cpu), cpu.planes)).all(1).numpy()
        tied = assert_topk_match(res.ids.cpu().numpy()[same], res.scores.cpu().numpy()[same],
                                 plain.ids.numpy()[same], plain.scores.numpy()[same])
        log(f"index family lsh n_bits={LSH_BITS} T={t}: recall@10={rec:.4f} evals/q={t} "
            f"build_s={build_s:.4f} ms={ms:.4f} (median of 20); Hamming stage "
            f"(mips_topk select route, B={b} N={n} d={d} k={t}) bit-identical to the plain "
            f"version, rows whose cut splits a tie group={int(split.sum())}/{b}, ms="
            f"{_ms(hamming_ms)} select_ms={_ms(select_ms)} "
            f"call_ms={call_ms:.4f} library_call_ms={library_call_ms:.4f} "
            f"bound_ms={bound_ms:.5f} bound_by={by} "
            f"candidates_median={cands.median().item():.0f} candidates_max="
            f"{cands.max().item():.0f} rows_from_scores="
            f"{int((cands > select_plan(n, t)[1]).sum())}; whole search against the CPU "
            f"copy: {int(same.sum())} rows with equal query codes, near_tie_rows={len(tied)}")
    assert 0 < recalls[0] < recalls[-1], f"lsh: recall@10 {recalls} does not rise with T"


def phase_family_serve_default() -> None:
    """Each class at the serve default (``scripts/index_family_reference.py``,
    the same protocol): HierarchicalIpNSW and NormFilteredIndex against the
    JAX package's recall; SimpleLSH, for plane seeds 0-9, against the port's
    own recall on the CPU seed for seed, and its mean against JAX's."""
    import numpy as np

    from repro_torch.core import HierarchicalIpNSW, NormFilteredIndex, SimpleLSH
    from repro_torch.data import mips_dataset, mips_queries
    from repro_torch.obs.recall import recall_at_k

    items = mips_dataset(20_000, 64, "lognormal", seed=0).astype(np.float32)
    queries = mips_queries(256, 64, seed=1).astype(np.float32)
    gt = np.argsort(-(queries.astype(np.float64) @ items.astype(np.float64).T), axis=1,
                    kind="stable")[:, :10]
    got = {}
    hnsw = HierarchicalIpNSW(storage="int8", **FAMILY_BUILD).build(items)
    nf = NormFilteredIndex(keep_frac=FAMILY_KEEP, plus=True, storage="int8",
                           **FAMILY_BUILD).build(items)
    for storage in ("f32", "int8"):
        for name, index in (("hnsw", hnsw), ("norm_filter", nf)):
            got[f"{name}_{storage}"] = recall_at_k(
                index.search(queries, k=10, ef=FAMILY_EF, storage=storage).ids.cpu().numpy(), gt)
    for name, rec in got.items():
        log(f"index family serve default {name}: recall@10={rec:.4f} "
            f"(JAX {JAX_FAMILY_RECALL[name]:.4f}, margin {RECALL_MARGIN})")
        assert abs(rec - JAX_FAMILY_RECALL[name]) <= RECALL_MARGIN, \
            f"serve default {name}: recall {rec} not within {RECALL_MARGIN} of JAX's"
    lsh_recall = {name: [] for name in PORT_CPU_LSH_RECALL}
    for seed in range(len(PORT_CPU_LSH_RECALL["lsh_t100"])):
        lsh = SimpleLSH(n_bits=LSH_BITS, seed=seed).build(items)
        for t in LSH_CANDIDATES:
            lsh_recall[f"lsh_t{t}"].append(recall_at_k(
                lsh.search(queries, k=10, n_candidates=t).ids.cpu().numpy(), gt))
    for name, recalls in lsh_recall.items():
        off = [abs(a - b) for a, b in zip(recalls, PORT_CPU_LSH_RECALL[name])]
        mean = float(np.mean(recalls))
        log(f"index family serve default {name} plane seeds 0-{len(recalls) - 1}: recall@10="
            f"{['%.7f' % r for r in recalls]}; against the port on the CPU, largest difference "
            f"{max(off):.7f} (tolerance {LSH_CPU_TOL:.7f}); mean {mean:.7f} against JAX's "
            f"{JAX_LSH_MEAN_RECALL[name]:.7f} (margin {LSH_RECALL_MARGIN})")
        assert max(off) <= LSH_CPU_TOL, \
            f"serve default {name}: the card's recall {recalls} is not the CPU's"
        assert abs(mean - JAX_LSH_MEAN_RECALL[name]) <= LSH_RECALL_MARGIN, \
            f"serve default {name}: mean recall {mean} not within {LSH_RECALL_MARGIN} of JAX's"


def phase_family_per_step(searched, queries) -> None:
    """The hierarchy's searches again with per-step walks (the host loop of
    the beam_step kernel): every level's walk, the pool-of-one descent
    included, gives the fused walk's outputs."""
    import torch

    for storage, (index, fused) in searched.items():
        with per_step_walks(capturable=True):
            looped = index.search(queries, k=10, ef=FAMILY_EF, storage=storage)
        for field in ("ids", "scores", "evals", "visited"):
            x, y = getattr(fused, field), getattr(looped, field)
            assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                               y.view(torch.int32) if y.dtype == torch.float32 else y), \
                f"hnsw {storage}: {field} differs from the per-step loop's"
        assert fused.steps == looped.steps
        log(f"index family hnsw storage={storage}: the per-step loop's ids, score bits, evals "
            f"and visited equal the fused walks' on every level")


def phase_family_plain_levels() -> None:
    """A hierarchy on integer items (every dot product exact; d 300, the
    full-size knobs, FAMILY_PLAIN_N items) built on the card with both
    drivers and on the CPU, where every wrapper runs its plain version:
    every level bit for bit, the bootstrap of the top levels under a batch
    and under M included; searched f32 and int8 on integer queries, ids,
    score bits, evals and steps equal to the CPU's."""
    import numpy as np
    import torch

    from repro_torch.core import HierarchicalIpNSW

    rng = np.random.default_rng(4)
    items = (rng.choice([-1.0, 1.0], size=(FAMILY_PLAIN_N, D_FULL))
             * rng.choice([1.0, 2.0, 4.0], size=(FAMILY_PLAIN_N, 1))).astype(np.float32)
    queries = rng.integers(-3, 4, (256, D_FULL)).astype(np.float32)
    t0 = time.perf_counter()
    plain = HierarchicalIpNSW(storage="int8", device="cpu", **FAMILY_BUILD).build(items)
    plain_s = time.perf_counter() - t0
    sizes = [int(g.size) for g in plain.levels]
    for driver in ("host", "scan"):
        card = HierarchicalIpNSW(build_backend=driver, storage="int8", **FAMILY_BUILD).build(items)
        _same_levels(f"hnsw integer items, {driver} on the card against the CPU", card, plain)
    for storage in ("f32", "int8"):
        got = card.search(queries, k=10, ef=FAMILY_EF, storage=storage)
        want = plain.search(queries, k=10, ef=FAMILY_EF, storage=storage)
        for field in ("ids", "scores", "evals", "visited"):
            x, y = getattr(got, field).cpu(), getattr(want, field)
            assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                               y.view(torch.int32) if y.dtype == torch.float32 else y), \
                f"hnsw integer items {storage}: {field} differs from the CPU's"
        assert int(got.steps) == int(want.steps), f"hnsw integer items {storage}: steps"
    log(f"index family hnsw integer items N={FAMILY_PLAIN_N} d={D_FULL} level_sizes={sizes}: "
        f"every level of the host and the scan build on the card bit-identical to the build "
        f"on the CPU ({plain_s:.1f} s); f32 and int8 searches' ids, score bits, evals, visited "
        f"and steps equal")


def phase_index_family() -> dict:
    """Phase 8: the rest of the index family; returns its launches."""
    import numpy as np
    import torch

    from repro_torch.core import IpNSW, IpNSWPlus
    from repro_torch.core.brute_force import exact_topk
    from repro_torch.data import mips_dataset, mips_queries

    items = torch.as_tensor(mips_dataset(N_FULL, D_FULL, "lognormal", seed=0).astype(np.float32),
                            device="cuda")
    queries = torch.as_tensor(mips_queries(256, D_FULL, seed=1).astype(np.float32),
                              device="cuda")
    flat = {}  # phase 5's flat classes, beside the family: built before the count
    for name, cls in (("ipnsw", IpNSW), ("ipnsw_plus", IpNSWPlus)):
        flat[name], flat[f"{name}_build_s"], _ = _timed_build(
            lambda: cls(**FAMILY_BUILD).build(items))
    _zero_counts()
    t0 = time.perf_counter()
    gt = exact_topk(queries, items, k=10)[1].cpu().numpy()
    searched = phase_family_hnsw(items, queries, gt, flat)
    phase_family_norm_filter(items, queries, gt, flat)
    phase_family_lsh(items, queries, gt)
    phase_family_serve_default()
    counts = _read_counts()
    log(f"index family phase: {time.perf_counter() - t0:.1f} s launches={counts}")
    _assert_path("index family", counts, FAMILY_PATH)
    phase_family_per_step(searched, queries)
    phase_family_plain_levels()
    return counts


# ------------------------------------------------------------------ phase 9
RECSYS_ARCHS = ("sasrec", "mind", "dien", "dlrm-rm2")
RECSYS_TRAIN_STEPS = 3
RECSYS_CPU_ROWS, RECSYS_CPU_BATCH = 100_000, 256  # (b): tables cut, batch
RECSYS_CPU_USERS, RECSYS_CPU_CANDIDATES = 16, 20_000  # (b): retrieval rows, DLRM's candidates
RECSYS_GRAD_RTOL = 1e-4   # (b): a gradient leaf, relative to its largest element
# (b): serve and retrieval scores, relative to their row's largest: the user
# vector comes out of a whole tower, so a score near zero carries the
# rounding of the tower's larger values
RECSYS_SCORE_RTOL = 1e-5
RECSYS_INDEX_USERS = 1_024
RECSYS_INDEX_EFS = (40, 80, 160)
# `PYTHONPATH=src python examples/train_and_serve_torch.py --device cpu` (the
# port on the CPU; 2,000 x 20,000, d 32, 300 steps of 4,096) printed loss
# 0.0342 -> 0.0329 and recall@10 0.624 / 0.759 / 0.877 at ef 20 / 40 / 80;
# unrounded:
PORT_CPU_EXAMPLE = {"loss_final": 0.03288940712809563,
                    "recall": {20: 0.6240234375, 40: 0.7587890625, 80: 0.8771484375}}
EXAMPLE_LOSS_RTOL = 1e-3
ADAMW_BYTES_PER_PARAM = 28  # read p, g, m, v; write p, m, v (fp32)
RECSYS_PATH = ("gather_score", "mips_topk", "mips_topk_select", "beam_walk", "commit_merge")


def _recsys_inputs(arch, abstract, g, batch: int = 0):
    """Inputs of the shapes and dtypes of ``abstract`` (a cell's meta
    batch, or its meta hist), on the card: ``hist`` a valid prefix of
    random length then -1 (as SyntheticClickStream draws it), labels 0 / 1,
    dense features normal, every other id uniform over the table.
    ``batch``: another number of rows than the cell's."""
    import torch

    def make(name, t):
        shape = (batch or t.shape[0], *t.shape[1:])
        if name == "hist":
            ids = torch.randint(0, arch.n_ids, shape, generator=g, device="cuda",
                                dtype=torch.int32)
            lengths = torch.randint(1, shape[1] + 1, (shape[0], 1), generator=g, device="cuda")
            return ids.masked_fill(torch.arange(shape[1], device="cuda") >= lengths, -1)
        if name == "labels":
            return torch.randint(0, 2, shape, generator=g, device="cuda").float()
        if t.dtype == torch.float32:
            return torch.randn(shape, generator=g, device="cuda")
        return torch.randint(0, arch.n_ids, shape, generator=g, device="cuda", dtype=torch.int32)

    if isinstance(abstract, dict):
        return {name: make(name, t) for name, t in abstract.items()}
    return make("hist", abstract)


def _scaled_err(got, want) -> float:
    """max |got - want| over the largest |want| of the same row."""
    return float(((got - want).abs() / want.abs().amax(dim=-1, keepdim=True)).max())


def _synced_ms(fn, reps: int) -> list:
    """Wall ms of each of ``reps`` calls, each ended by a synchronize."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_recsys_train(arch, params, g) -> tuple:
    """(a) train_batch: RECSYS_TRAIN_STEPS steps of the cell's step at the
    published widths; loss, step ms (mean of steps 2-3), the optimizer's ms
    (adamw_update alone on the last gradients, CUDA events) against its
    bound, peak memory.  Returns (params, opt, batch)."""
    import torch

    from repro_torch.train import adamw_init, adamw_update, cosine_schedule, value_and_grad
    from repro_torch.train.tree import leaves

    cell = arch.build_cell("train_batch")
    b = cell.meta["batch"]
    batch = _recsys_inputs(arch, cell.args[2], g)
    opt = adamw_init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for _ in range(RECSYS_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = cell.step_fn(params, opt, batch)
        losses.append(float(loss))
        walls.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert all(map(lambda x: x == x and abs(x) < float("inf"), losses)), \
        f"{cell.name}: loss not finite: {losses}"
    with uncounted():
        _, grads = value_and_grad(arch.loss_fn())(params, batch, arch.cfg)
        lr = cosine_schedule(opt.step, base_lr=1e-3, warmup=500, total=50_000)
        opt_ms = cuda_ms(lambda: adamw_update(grads, opt, params, lr=lr), reps=3, warmup=1)
        del grads
    n_params = sum(p.numel() for p in leaves(params))
    opt_bound_ms, _ = bound(ADAMW_BYTES_PER_PARAM * n_params, 0)
    step_ms = sum(walls[1:]) / len(walls[1:])
    line = (f"recsys {cell.name} B={b} "
            f"loss={'/'.join(f'{x:.6f}' for x in losses)} step_ms={step_ms:.2f} "
            f"walls={'/'.join(f'{w:.1f}' for w in walls)} optimizer_ms={opt_ms:.3f} "
            f"optimizer_bound_ms={opt_bound_ms:.3f} optimizer_share={opt_ms / step_ms:.3f} "
            f"params={n_params} peak_gib={peak:.2f}")
    log(line)
    return params, opt, batch


def phase_recsys_serve(arch, params, g) -> None:
    """(a) serve_p99, serve_bulk, retrieval_cand: ms (mean of 3 synced
    calls after a warm one) and peak memory; outputs finite, retrieval ids
    in the table, sorted by score."""
    import torch

    for shape in ("serve_p99", "serve_bulk", "retrieval_cand"):
        cell = arch.build_cell(shape)
        inputs = _recsys_inputs(arch, cell.args[1], g)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = cell.step_fn(params, inputs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        with uncounted():
            walls = _synced_ms(lambda: cell.step_fn(params, inputs), 3)
        if isinstance(out, dict):
            s, i = out["scores"], out["ids"]
            assert bool(torch.isfinite(s).all()), f"{cell.name}: scores not finite"
            assert bool(((i >= 0) & (i < (cell.meta["n_cand"] if arch.arch_id == "dlrm-rm2"
                                           else arch.n_ids))).all()), f"{cell.name}: ids"
            assert bool((s[..., 1:] <= s[..., :-1]).all()), f"{cell.name}: not sorted"
        else:
            assert bool(torch.isfinite(out).all()), f"{cell.name}: scores not finite"
        log(f"recsys {cell.name} B={cell.meta['batch']} n_cand={cell.meta['n_cand']} "
            f"ms={sum(walls) / len(walls):.3f} walls={'/'.join(f'{w:.2f}' for w in walls)} "
            f"peak_gib={peak:.2f} out={list(out['ids'].shape) if isinstance(out, dict) else list(out.shape)}")
        del inputs, out


def phase_recsys_cpu(aid: str) -> None:
    """(b) The card against the plain CPU computation at the published
    widths, the tables cut to RECSYS_CPU_ROWS and a batch of
    RECSYS_CPU_BATCH: the loss within rtol 1e-5, every gradient leaf within
    RECSYS_GRAD_RTOL of its largest element, serve and retrieval scores
    within RECSYS_SCORE_RTOL of their row's largest, retrieval ids equal up
    to near-ties (two scores within that tolerance)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.train import value_and_grad
    from repro_torch.train.tree import named_leaves, tree_map

    base = get_arch(aid)
    field = "n_rows" if aid == "dlrm-rm2" else "n_items"
    arch = dataclasses.replace(base, cfg=dataclasses.replace(base.cfg, **{field: RECSYS_CPU_ROWS}))
    cpu_params = arch.init(torch.Generator().manual_seed(1), device="cpu")
    gpu_params = tree_map(lambda t: t.to("cuda"), cpu_params)
    g = torch.Generator(device="cuda").manual_seed(2)
    worst = {}
    for shape in ("train_batch", "serve_p99", "retrieval_cand"):
        gpu_cell, cpu_cell = arch.build_cell(shape), arch.build_cell(shape, device="cpu")
        rows = {"train_batch": RECSYS_CPU_BATCH, "serve_p99": RECSYS_CPU_BATCH,
                "retrieval_cand": RECSYS_CPU_CANDIDATES if aid == "dlrm-rm2" else RECSYS_CPU_USERS}
        gpu_in = _recsys_inputs(arch, gpu_cell.args[-1], g, batch=rows[shape])
        cpu_in = tree_map(lambda t: t.cpu(), gpu_in)
        if shape == "train_batch":
            loss_fn = arch.loss_fn()
            gl, gg = value_and_grad(loss_fn)(gpu_params, gpu_in, arch.cfg)
            cl, cg = value_and_grad(loss_fn)(cpu_params, cpu_in, arch.cfg)
            assert np.isclose(float(gl), float(cl), rtol=1e-5, atol=0), \
                f"{aid}: loss {float(gl)!r} on the card, {float(cl)!r} on the CPU"
            cpu_grads = dict(named_leaves(cg))
            for name, leaf in named_leaves(gg):
                ref = cpu_grads[name]
                err = float((leaf.cpu() - ref).abs().max())
                scale = float(ref.abs().max())
                assert err <= RECSYS_GRAD_RTOL * scale, \
                    f"{aid} grad {name}: max error {err:.3g} over {scale:.3g}"
                worst[name] = err / scale if scale else 0.0
            worst_leaf = max(worst, key=worst.get)
            line = (f"loss_card={float(gl):.8f} loss_cpu={float(cl):.8f} "
                    f"grad_worst={worst[worst_leaf]:.3g} ({worst_leaf})")
        elif shape == "serve_p99":
            got, want = gpu_cell.step_fn(gpu_params, gpu_in).cpu(), cpu_cell.step_fn(cpu_params,
                                                                                     cpu_in)
            err = _scaled_err(got, want)
            assert err <= RECSYS_SCORE_RTOL, f"{aid} serve: scores {err:.3g} of a row's largest"
            line += f" serve_err={err:.3g}"
        else:
            got, want = gpu_cell.step_fn(gpu_params, gpu_in), cpu_cell.step_fn(cpu_params, cpu_in)
            gi, gs = got["ids"].cpu(), got["scores"].cpu()
            ci, cs = want["ids"], want["scores"]
            if gi.dim() == 1:
                gi, gs, ci, cs = gi[None], gs[None], ci[None], cs[None]
            err = _scaled_err(gs, cs)
            assert err <= RECSYS_SCORE_RTOL, f"{aid} retrieval: scores {err:.3g} of a row's largest"
            # ids equal but where the two scores of a slot tie within that tolerance
            differ = gi != ci
            tol = RECSYS_SCORE_RTOL * cs.abs().amax(dim=-1, keepdim=True)
            assert not bool((differ & ((gs - cs).abs() > tol)).any()), f"{aid}: retrieval ids"
            line += (f" retrieval_err={err:.3g} retrieval_near_tie_rows="
                     f"{int(differ.any(dim=-1).sum())} of {gi.shape[0]}")
    log(f"recsys card_vs_cpu {aid} rows={RECSYS_CPU_ROWS} batch={RECSYS_CPU_BATCH} {line}")


def phase_recsys_checkpoint(arch, params, opt, batch) -> None:
    """(c) SASRec's whole train state saved and restored on the card bit for
    bit, then one step from the restored state equal to the uninterrupted
    run's step (bit for bit where that step repeats itself bit for bit)."""
    import shutil

    import torch

    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.tree import named_leaves

    state = {"params": params, "opt": opt}
    d = ROOT / "build" / "recsys_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    ckpt.save(str(d), int(opt.step), state, extra={"arch": arch.arch_id})
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored, manifest = ckpt.restore(str(d), state, device="cuda")
    restore_s = time.perf_counter() - t0
    assert manifest["step"] == int(opt.step)
    for (name, a), (_, b) in zip(named_leaves(state), named_leaves(restored)):
        assert b.device.type == "cuda" and a.dtype == b.dtype, name
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b), \
            f"checkpoint: {name} differs after the round trip"
    cell = arch.build_cell("train_batch")
    with uncounted():
        first = named_leaves(cell.step_fn(params, opt, batch))
        again = named_leaves(cell.step_fn(params, opt, batch))
        resumed = named_leaves(cell.step_fn(restored["params"], restored["opt"], batch))
    # the uninterrupted step run twice: where it repeats itself bit for bit,
    # the resumed step must equal it bit for bit; where it does not (atomic
    # adds in a gradient), each leaf within the two runs' own difference
    deterministic = all(torch.equal(x, y) for (_, x), (_, y) in zip(first, again))
    for (name, x), (_, y), (_, z) in zip(first, again, resumed):
        spread = 0.0 if deterministic else float((x - y).abs().max())
        err = float((x - z).abs().max()) if x.is_floating_point() else float(not torch.equal(x, z))
        assert err <= spread, f"checkpoint: the resumed step differs at {name}: {err} > {spread}"
    shutil.rmtree(d, ignore_errors=True)
    n = sum(t.numel() for _, t in named_leaves(state))
    log(f"recsys checkpoint {arch.arch_id} step={manifest['step']} leaves="
        f"{len(manifest['leaves'])} values={n} bit_identical=True step_deterministic="
        f"{deterministic} resumed_step_equal=True "
        f"save_s={save_s:.2f} restore_s={restore_s:.2f}")


def phase_recsys_index(arch, params, g) -> None:
    """(d) IpNSW+ (scan driver) over SASRec's trained 10^6 x 50 item table,
    searched with RECSYS_INDEX_USERS user embeddings: recall@10 against
    exact_topk at each ef, rising with ef; evals a query, build s, ms."""
    import numpy as np
    import torch

    from repro_torch.core import IpNSWPlus, exact_topk, recall_at_k
    from repro_torch.models.recsys.sasrec import user_embedding

    items = params["item_emb"].detach().contiguous()
    hist = _recsys_inputs(arch, arch.build_cell("retrieval_cand").args[1], g,
                          batch=RECSYS_INDEX_USERS)
    with torch.no_grad():
        users = user_embedding(params, hist, arch.cfg).contiguous()
    gt = exact_topk(users, items, k=10)[1].cpu().numpy()
    index, build_s, _ = _timed_build(lambda: IpNSWPlus(**FAMILY_BUILD, build_backend="scan",
                                                       device="cuda").build(items))
    recalls = []
    line = f"recsys index sasrec N={items.shape[0]} d={items.shape[1]} build_s={build_s:.2f}"
    for ef in RECSYS_INDEX_EFS:
        r = index.search(users, k=10, ef=ef)
        recalls.append(recall_at_k(r.ids.cpu().numpy(), gt))
        with uncounted():
            ms = float(np.median(_synced_ms(lambda: index.search(users, k=10, ef=ef), 5)))
        line += (f" ef{ef}: recall@10={recalls[-1]:.4f} evals={float(r.evals.float().mean()):.1f}"
                 f" ms={ms:.3f}")
    log(line)
    assert all(a < b for a, b in zip(recalls, recalls[1:])), f"recall does not rise with ef: {recalls}"


def phase_recsys_example() -> None:
    """(e) examples/train_and_serve_torch.py at its defaults on the card:
    the final loss within EXAMPLE_LOSS_RTOL of the port's CPU run, recall@10
    at each ef within RECALL_MARGIN of it."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import train_and_serve_torch as example
    finally:
        sys.path.remove(str(ROOT / "examples"))
    out = example.main(["--device", "cuda"])
    want = PORT_CPU_EXAMPLE
    rel = abs(out["loss_final"] - want["loss_final"]) / want["loss_final"]
    log(f"recsys example loss_final={out['loss_final']!r} (CPU {want['loss_final']!r}, rel "
        f"{rel:.3g}) train_s={out['train_s']:.2f} build_s={out['build_s']:.2f} " + " ".join(
            f"ef{ef}: recall@10={r!r} (CPU {want['recall'][ef]!r}) evals={out['evals'][ef]:.1f}"
            for ef, r in out["recall"].items()))
    assert rel <= EXAMPLE_LOSS_RTOL, f"example: loss {out['loss_final']} against the CPU's"
    for ef, r in out["recall"].items():
        assert abs(r - want["recall"][ef]) <= RECALL_MARGIN, f"example: recall at ef {ef}: {r}"


def phase_recsys() -> dict:
    """Phase 9: the recsys towers and the training substrate; returns the
    launches of its driven steps, index and example."""
    import torch

    from repro_torch.configs import get_arch

    gc.collect()  # the earlier phases' indexes: DLRM's step needs 56 GiB of the card
    torch.cuda.empty_cache()
    # phase 3's checks at the recsys shapes, here at the end of the run: their
    # profiler sessions, on top of phase 3's, left the profiler dropping a
    # session's last events, and phases 3-5 count the events they see
    g = torch.Generator(device="cuda")
    g.manual_seed(9)
    phase_recsys_kernels(g)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _zero_counts()
    for aid in RECSYS_ARCHS:
        arch = get_arch(aid)
        g = torch.Generator(device="cuda").manual_seed(0)
        params = arch.init(g, device="cuda")
        params, opt, batch = phase_recsys_train(arch, params, g)
        phase_recsys_serve(arch, params, g)
        if aid == "sasrec":
            phase_recsys_checkpoint(arch, params, opt, batch)
            del opt, batch
            phase_recsys_index(arch, params, g)
        del params
        torch.cuda.empty_cache()
    phase_recsys_example()
    counts = _read_counts()
    with uncounted():
        for aid in RECSYS_ARCHS:
            phase_recsys_cpu(aid)
    log(f"recsys phase: {time.perf_counter() - t0:.1f} s launches={counts}")
    _assert_path("recsys", counts, RECSYS_PATH)
    return counts


# ----------------------------------------------------------------- phase 10
LM_ARCHS = ("granite-3-2b", "gemma3-12b", "internlm2-20b", "qwen3-moe-235b-a22b", "grok-1-314b")
# (a) the cuts that fit one 80 GB card: arch -> (layers or None, prefill
# batch, decode batch); the published batches are 32 (prefill_32k) and 128
# (decode_32k); gemma's long_500k runs at its published batch of 1, uncut.
# qwen3's and grok's bf16 weights (438 and 590 GiB) need the layer cut
# first.  Each batch is the largest whose peak, extrapolated from a run at
# a smaller one (the "batch_that_fits" each cell logs), stays near 72 GiB
# of the card's 79; PERF.md §4 records each cut beside its peak memory.
LM_CUTS = {"granite-3-2b": (None, 16, 26),
           "gemma3-12b": (None, 10, 21),
           "internlm2-20b": (None, 3, 6),
           "qwen3-moe-235b-a22b": (10, 2, 36),
           "grok-1-314b": (5, 2, 36)}
LM_DECODE_STEPS = 4
# (a) the prefill_32k cells of the three deep archs are timed at an eighth of
# their layers (whole pattern cycles; the weights of every layer held), the
# rest at LM_CUTS' layers: a 32k prefill is one pass a layer, 15-18 s at full
# depth (PERF.md §4), and the run's time limit pays for phase 12.  Each logs
# the peak it would reach at full depth (the caches of the layers it skipped
# added) and the batch that fits there.
LM_PREFILL_LAYERS = {"granite-3-2b": 5, "gemma3-12b": 6, "internlm2-20b": 6}
CARD_GIB = 72  # what a cell may plan to hold of the card's 79 GiB
# (b) card against CPU: layers cut to one pattern cycle, all experts, fp32
LM_CPU_LAYERS = {"granite-3-2b": 2, "gemma3-12b": 6, "internlm2-20b": 2,
                 "qwen3-moe-235b-a22b": 2, "grok-1-314b": 1}
# (b) 5 decode steps (8 before phase 13 (h)-(i), which their time pays for)
LM_CPU_BATCH, LM_CPU_PROMPT, LM_CPU_STEPS = 2, 256, 5
LM_LOGIT_RTOL = 1e-4  # (b): a logit, relative to its row's largest |logit|
# (b): a block's output on the card, relative to its row's largest |value|:
# a block's fp32 output is up to 7.6e-5 of that from a float64 run on the
# same input (gemma's first block; scripts/lm_conditioning.py), and the card
# and the CPU each carry such an error
LM_BLOCK_RTOL = 2.5e-4
# flash_attn at the LM path's shapes, checked (against the plain version
# under FLASH_TOL) and timed beside SDPA, at the end of the run (phase 10,
# as phase 9 runs its own phase 3 checks).  S = 1 edges first (small T,
# ragged T, a q_offset before the last key), fp32 and bf16:
FLASH_DECODE_EDGES = {"s1_small": (2, 1, 100, 4, 2, 64, 99, None),
                      "s1_ragged": (3, 1, 1000, 8, 2, 128, 999, None),
                      "s1_before_end": (2, 1, 777, 4, 1, 256, 300, None)}
# then the cells (B from LM_CUTS): decode reads a cache of T slots at
# q_offset = min(position, T - 1) (models/layers.attention); gemma's local
# ring is its 1,024-slot cache past the wrap (position 32,770, mapped to
# 1,023); granite's prefill is one S = T = 32,768 call, held in row blocks
FLASH_LM_SHAPES = {
    "granite_decode": (LM_CUTS["granite-3-2b"][2], 1, 32768, 32, 8, 64, 32767, None),
    "gemma_global_decode": (LM_CUTS["gemma3-12b"][2], 1, 32768, 16, 8, 256, 32767, None),
    "gemma_long_500k": (1, 1, 524288, 16, 8, 256, 524287, None),
    "gemma_local_ring": (LM_CUTS["gemma3-12b"][2], 1, 1024, 16, 8, 256, 1023, None),
    "internlm2_decode": (LM_CUTS["internlm2-20b"][2], 1, 32768, 48, 8, 128, 32767, None),
    "qwen3_decode": (LM_CUTS["qwen3-moe-235b-a22b"][2], 1, 32768, 64, 4, 128, 32767, None),
    "granite_prefill": (LM_CUTS["granite-3-2b"][1], 32768, 32768, 32, 8, 64, 0, None),
}
FLASH_LM_FP32 = ("granite_decode", "gemma_local_ring", "internlm2_decode")
GEMMA_RING_POSITION = 32770
PREFILL_ROW_BLOCKS = (0, 16384, 32768 - 64)  # first rows of the 64-row blocks held
CHECK_GIB = 8  # a plain check's fp32 kv copies at most (the batch is split)


def _lm_sdpa(q, k, v, q_offset: int, window):
    """scaled_dot_product_attention on the same inputs; a decode row that
    sees every key needs no mask (the flash backend takes it)."""
    import torch.nn.functional as F

    if q.shape[1] == 1 and q_offset >= k.shape[1] - 1 and window is None:
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        return lambda: F.scaled_dot_product_attention(qh, kh, vh, enable_gqa=True)
    return _sdpa(q, k, v, q_offset, window)


def _ring_reference(q, ck, cv, position: int, window: int):
    """JAX's decode over a ring cache (layers.py:330-344) in fp32: slot s
    holds position ``position - ((position - s) mod T)``, kept where it is
    in ``(position - window, position]`` and >= 0."""
    import torch

    t, hd = ck.shape[1], q.shape[-1]
    g = q.shape[2] // ck.shape[2]
    sl = torch.arange(t, device=q.device)
    k_pos = position - torch.remainder(position - sl, t)
    keep = (k_pos <= position) & (k_pos >= 0) & (k_pos > position - window)
    kh, vh = (x.float().repeat_interleave(g, 2).transpose(1, 2) for x in (ck, cv))
    logits = q.float().transpose(1, 2) @ kh.transpose(-1, -2) / hd ** 0.5
    p = torch.softmax(logits.masked_fill(~keep, float("-inf")), dim=-1)
    return (p @ vh).transpose(1, 2)


def check_flash_lm_cell(cell: str, shape, dtype, g):
    """flash_attention at an LM shape against the plain version (FLASH_TOL)
    in batch slices whose fp32 kv copies stay under CHECK_GIB; a prefill
    cell in row blocks (PREFILL_ROW_BLOCKS, by q_offset: its [S, T] scores
    do not fit); the ring cell in fp32 also against JAX's ring mask.
    Returns (q, k, v, largest error)."""
    import torch

    from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref

    b, s, t, h, kv, hd, off, win = shape
    dname = str(dtype).split(".")[-1]
    q, k, v = _flash_inputs(shape, dtype, g)
    got = flash_attention(q, k, v, q_offset=off, window=win)
    torch.cuda.synchronize()
    per_row = 2 * t * h * hd * 4 * max(s, 64) / 64  # fp32 repeated k and v of one batch row
    step = max(1, min(b, int(CHECK_GIB * 2**30 // per_row)))
    err = 0.0
    for b0 in range(0, b, step):
        qs, ks, vs = (x[b0:b0 + step] for x in (q, k, v))
        if s == 1:
            blocks = [(0, 1)]
        else:
            blocks = [(r, min(r + 64, s)) for r in PREFILL_ROW_BLOCKS]
        for r0, r1 in blocks:
            qb = qs[:, r0:r1].contiguous()
            want = flash_attention_ref(qb, ks, vs, q_offset=off + r0, window=win)
            spread = _flash_spread(qb, ks, vs, off + r0, win)
            e, _ = _check_flash(f"{cell}/{dname} b{b0} rows[{r0},{r1})",
                                got[b0:b0 + step, r0:r1], want, spread, FLASH_TOL[dname])
            err = max(err, e)
            del want, spread
        if cell == "gemma_local_ring" and dtype == torch.float32:
            ring = _ring_reference(qs, ks, vs, GEMMA_RING_POSITION, 1024)
            spread = _flash_spread(qs, ks, vs, off, win)
            e, _ = _check_flash(f"{cell}/{dname} b{b0} against JAX's ring mask at position "
                                f"{GEMMA_RING_POSITION}", got[b0:b0 + step], ring, spread,
                                FLASH_TOL[dname])
            err = max(err, e)
        torch.cuda.empty_cache()
    return q, k, v, err


def phase_lm_kernels(g) -> None:
    """flash_attn at the S = 1 edges (check_flash_cell) and at the LM
    path's shapes (check_flash_lm_cell), each LM cell timed beside the
    plain version (decode; not prefill, whose scores do not fit), SDPA and
    its byte bound (the cache read once)."""
    import torch

    from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref
    from repro_torch.kernels.flash_attn.ops import forward_cost

    for cell, shape in FLASH_DECODE_EDGES.items():
        b, s, t, h, kv, hd, off, win = shape
        for dtype in (torch.float32, torch.bfloat16):
            *_, err, n_empty = check_flash_cell(cell, shape, dtype, g)
            log(f"kernel=flash_attn edge={cell} dtype={str(dtype).split('.')[-1]} B={b} S={s} "
                f"T={t} H={h} KV={kv} hd={hd} q_offset={off} window={win} "
                f"rows_without_keys={n_empty} max_abs_err={err:.3g}")
    for cell, shape in FLASH_LM_SHAPES.items():
        b, s, t, h, kv, hd, off, win = shape
        dtypes = (torch.float32, torch.bfloat16) if cell in FLASH_LM_FP32 else (torch.bfloat16,)
        for dtype in dtypes:
            dname = str(dtype).split(".")[-1]
            q, k, v, err = check_flash_lm_cell(cell, shape, dtype, g)
            run = lambda: flash_attention(q, k, v, q_offset=off, window=win)  # noqa: E731
            ms = _device_ms_or_none(run)
            call_ms = cuda_ms(run, reps=5, warmup=1)
            plain_ms = None
            if s == 1:  # a prefill's [S, T] scores do not fit
                plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, q_offset=off, window=win),
                                   reps=3, warmup=1)
                torch.cuda.empty_cache()
            library_ms = cuda_ms(_lm_sdpa(q, k, v, off, win), reps=3, warmup=1)
            torch.cuda.empty_cache()
            flops, nbytes = forward_cost(b, s, t, h, kv, hd, off, win, q.element_size())
            rate = FP32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S
            bound_ms, by = bound(nbytes, flops, rate)
            rows = 128 if dtype == torch.bfloat16 else 64
            blocks = -(-s // rows) * h * b
            best = ms if ms is not None else call_ms
            log(f"kernel=flash_attn lm_cell={cell} dtype={dname} B={b} S={s} T={t} H={h} KV={kv} "
                f"hd={hd} q_offset={off} window={win} blocks={blocks} (132 SMs) "
                f"flops={flops:.4g} bytes={nbytes:.4g} ms={_ms(ms)} call_ms={call_ms:.4f} "
                f"plain_ms={_ms(plain_ms)} (CUDA events) library_ms={_ms(library_ms)} "
                f"(SDPA, CUDA events) bound_ms={bound_ms:.5f} bound_by={by} "
                f"share_of_bound={bound_ms / best:.4f} rtol, atol, c={FLASH_TOL[dname]} "
                f"max_abs_err={err:.3g}")
            del q, k, v
            torch.cuda.empty_cache()


def _lm_cut(aid: str, layers=None, dtype=None):
    """The arch with its config's layers (and dtype) replaced."""
    import dataclasses

    from repro_torch.configs import get_arch

    arch = get_arch(aid)
    cfg = arch.cfg
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return dataclasses.replace(arch, cfg=cfg)


def _gib(x: float) -> float:
    return x / 2**30


def _fits(peak: float, weights: float, batch: int) -> int:
    """The largest batch a cell's peak extrapolates to under CARD_GIB:
    (peak - weights) grows with the batch."""
    per_row = (peak - weights) / batch
    return int((CARD_GIB * 2**30 - weights) // per_row) if per_row > 0 else batch


def phase_lm_prefill(arch, params, batch: int, weights: float, g) -> None:
    """(a) prefill_32k at ``batch`` and LM_PREFILL_LAYERS' depth: a warm-up
    prompt of 1,024 tokens, then one timed call (ms, tokens/s, peak, and the
    peak at full depth); logits finite."""
    import torch

    layers = arch.cfg.n_layers
    arch = _lm_cut(arch.arch_id, LM_PREFILL_LAYERS.get(arch.arch_id, layers))
    cell = arch.build_cell("prefill_32k")
    s = cell.args[1].shape[1]
    warm = torch.randint(0, arch.cfg.vocab, (batch, 1024), generator=g, device="cuda")
    out = cell.step_fn(params, warm)
    del out, warm
    tokens = torch.randint(0, arch.cfg.vocab, (batch, s), generator=g, device="cuda",
                           dtype=torch.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, caches = cell.step_fn(params, tokens)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    assert logits.shape == (batch, arch.cfg.vocab) and bool(torch.isfinite(logits).all()), \
        f"{cell.name}: logits not finite"
    cache = sum(c.numel() * c.element_size() for pair in caches for c in pair)
    full = peak + cache * (layers / arch.cfg.n_layers - 1)  # the skipped layers' caches
    log(f"lm {cell.name} layers={arch.cfg.n_layers} of {layers} B={batch} S={s} ms={wall:.1f} "
        f"tokens_per_s={batch * s / wall * 1e3:.0f} ms_per_layer={wall / arch.cfg.n_layers:.1f} "
        f"peak_gib={_gib(peak):.2f} cache_gib={_gib(cache):.2f} weights_gib={_gib(weights):.2f} "
        f"peak_at_{layers}_layers_gib~{_gib(full):.2f} "
        f"batch_that_fits~{_fits(full, weights, batch)} logits_finite=True")
    del logits, caches, tokens
    torch.cuda.empty_cache()


def phase_lm_decode(arch, params, shape: str, batch: int, weights: float, g) -> None:
    """(a) LM_DECODE_STEPS steps of ``shape``'s decode cell at ``batch`` on
    caches of seeded draws (a zero cache makes every softmax uniform), at
    q_offset seq - 4 ... seq - 1, each under sync debug mode "error" (a
    read-back fails the run), timed by CUDA events; logits finite.
    Returns the mean ms of the steps after the first."""
    import torch

    from repro_torch.models import transformer as tf

    cell = arch.build_cell(shape)
    s = cell.args[3] + 1
    torch.cuda.reset_peak_memory_stats()
    caches = tf.init_cache(arch.cfg, batch, s, device="cuda")
    for pair in caches:
        for c in pair:
            c.normal_(generator=g)
    token = torch.randint(0, arch.cfg.vocab, (batch, 1), generator=g, device="cuda")
    events = [torch.cuda.Event(enable_timing=True) for _ in range(LM_DECODE_STEPS + 1)]
    torch.cuda.synchronize()
    logits = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        events[0].record()
        for i in range(LM_DECODE_STEPS):
            lg, caches = cell.step_fn(params, caches, token, s - LM_DECODE_STEPS + i)
            events[i + 1].record()
            token = lg.argmax(-1)[:, None]
            logits.append(lg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    steps = [events[i].elapsed_time(events[i + 1]) for i in range(LM_DECODE_STEPS)]
    peak = torch.cuda.max_memory_allocated()
    assert all(bool(torch.isfinite(lg).all()) for lg in logits), f"{cell.name}: logits not finite"
    ms = sum(steps[1:]) / len(steps[1:])
    cache_gib = _gib(sum(c.numel() * c.element_size() for pair in caches for c in pair))
    log(f"lm {cell.name} layers={arch.cfg.n_layers} B={batch} T={s} steps_ms="
        f"{'/'.join(f'{x:.3f}' for x in steps)} ms_per_token={ms:.3f} "
        f"tokens_per_s={batch / ms * 1e3:.1f} cache_gib={cache_gib:.2f} "
        f"peak_gib={_gib(peak):.2f} weights_gib={_gib(weights):.2f} "
        f"batch_that_fits~{_fits(peak, weights, batch)} sync_debug=error logits_finite=True")
    if shape == "long_500k" or arch.arch_id in ("granite-3-2b", "qwen3-moe-235b-a22b"):
        _lm_step_breakdown(cell, params, caches, token, s - 1)
    del caches, logits
    torch.cuda.empty_cache()


def _lm_step_breakdown(cell, params, caches, token, q_offset: int) -> None:
    """Where one decode step's device time goes (torch.profiler): attention
    (flash_attn), matrix products, the rest; the largest kernels; the idle
    share of the step's wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with uncounted():
        cell.step_fn(params, caches, token, q_offset)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cell.step_fn(params, caches, token, q_offset)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    groups = {"attention": 0.0, "matmul": 0.0, "other": 0.0}
    for e in kernels:
        name = e.key.lower()
        key = "attention" if "flash_attn" in name else (
            "matmul" if any(w in name for w in ("gemm", "cutlass", "sm90_", "xmma", "nvjet"))
            else "other")
        groups[key] += e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"lm step breakdown {cell.name}: busy_ms={total:.3f} wall_ms(profiled)={wall:.3f} "
        f"idle_share={max(0.0, 1 - total / wall):.3f} "
        + " ".join(f"{k}_ms={v:.3f}" for k, v in groups.items()) + " top: "
        + "; ".join(f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.3f}ms"
                    for e in top))


def phase_lm_cells() -> None:
    """(a) every LM arch's prefill_32k and decode_32k, and gemma's
    long_500k, through LMArch.build_cell on the card at the published
    widths (bf16, random seeded weights drawn on the card), with LM_CUTS."""
    import torch

    from repro_torch.train.tree import leaves

    for aid in LM_ARCHS:
        layers, pre_b, dec_b = LM_CUTS[aid]
        arch = _lm_cut(aid, layers)
        g = torch.Generator(device="cuda").manual_seed(0)
        t0 = time.perf_counter()
        params = arch.init(g, device="cuda")
        torch.cuda.synchronize()
        weights = sum(t.numel() * t.element_size() for t in leaves(params))
        log(f"lm {aid} init layers={arch.cfg.n_layers} of {_lm_cut(aid).cfg.n_layers} "
            f"params={sum(t.numel() for t in leaves(params))} weights_gib={_gib(weights):.2f} "
            f"init_s={time.perf_counter() - t0:.2f}")
        phase_lm_prefill(arch, params, pre_b, weights, g)
        phase_lm_decode(arch, params, "decode_32k", dec_b, weights, g)
        if "long_500k" in arch.shape_names():
            phase_lm_decode(arch, params, "long_500k", 1, weights, g)
        del params
        gc.collect()
        torch.cuda.empty_cache()


def _lm_greedy(arch, params, prompt, tokens=None):
    """serve_prefill over ``prompt``, then LM_CPU_STEPS serve_steps fed
    ``tokens`` (host arrays) or, where None, the greedy token of the last
    logits: (the logits of each call on the CPU, the tokens fed)."""
    import torch

    from repro_torch.models import transformer as tf

    s = prompt.shape[1]
    lg, caches = tf.serve_prefill(params, prompt, arch.cfg, max_len=s + LM_CPU_STEPS)
    out, fed = [lg.cpu()], []
    for i in range(LM_CPU_STEPS):
        tok = out[-1].argmax(-1)[:, None].numpy() if tokens is None else tokens[i]
        fed.append(tok)
        lg, caches = tf.serve_step(params, caches, torch.as_tensor(tok, device=prompt.device),
                                   s + i, arch.cfg)
        out.append(lg.cpu())
    return out, fed


@contextlib.contextmanager
def _blocks(forced=None):
    """Patches models.transformer._block_apply to keep each block call's
    (input, output) on the CPU.  With ``forced`` (an earlier run's list), a
    call takes that run's input instead of its own and hands on that run's
    output after keeping its own: each block is compared on the same input,
    and the residual stream stays the earlier run's."""
    from repro_torch.models import transformer as tf

    original, seen = tf._block_apply, []

    def block(bp, x, *args, **kwargs):
        if forced is not None:
            x = forced[len(seen)][0].to(x.device)
        y, kv, aux = original(bp, x, *args, **kwargs)
        seen.append((x.cpu(), y.cpu()))
        if forced is not None:
            y = forced[len(seen) - 1][1].to(y.device)
        return y, kv, aux

    tf._block_apply = block
    try:
        yield seen
    finally:
        tf._block_apply = original


@contextlib.contextmanager
def _routes():
    """Patches models.moe.route to keep each call's expert ids and the
    router probs of its k-th and k+1-th choice, on the CPU."""
    from repro_torch.models import moe

    original, seen = moe.route, []

    def route(x2d, router, top_k):
        probs, vals, idx = original(x2d, router, top_k)
        ordered = probs.sort(dim=-1, descending=True).values
        seen.append((idx.cpu(), ordered[:, top_k - 1].cpu(), ordered[:, top_k].cpu()))
        return probs, vals, idx

    moe.route = route
    try:
        yield seen
    finally:
        moe.route = original


def phase_lm_cpu(aid: str) -> None:
    """(b) The card against the CPU at the published widths and vocab, the
    layers cut to one pattern cycle (LM_CPU_LAYERS, all experts), fp32,
    batch 2, a 256-token prompt and LM_CPU_STEPS decode steps (the CPU's
    greedy tokens fed to both).  A random model at these widths is chaotic in
    fp32 (JAX's init draws the queries at H**-0.5, so scores run to
    hundreds): the CPU's own fp32 logits are 1e-5 to 0.2 of a row's
    largest from a float64 run of the same weights, and an error grows
    20-40x an attention layer (scripts/lm_conditioning.py).  So each block
    runs on the card on the CPU run's input (``_blocks``): its output within
    LM_BLOCK_RTOL of the row's largest |value|, the logits (from the CPU's
    last hidden state) within LM_LOGIT_RTOL, the argmax equal but at
    near-ties, the MoE expert choices equal but where the router's k-th and
    k+1-th probs tie within 1e-5.  The card's free run is logged beside."""
    import numpy as np
    import torch

    from repro_torch.train.tree import tree_map

    arch = _lm_cut(aid, LM_CPU_LAYERS[aid], torch.float32)
    gpu_params = arch.init(torch.Generator(device="cuda").manual_seed(3), device="cuda")
    cpu_params = tree_map(lambda t: t.cpu(), gpu_params)
    prompt = np.random.default_rng(3).integers(0, arch.cfg.vocab, (LM_CPU_BATCH, LM_CPU_PROMPT))
    t0 = time.perf_counter()
    with _blocks() as cpu_blocks, _routes() as cpu_routes:
        cpu_out, tokens = _lm_greedy(arch, cpu_params, torch.as_tensor(prompt))
    cpu_s = time.perf_counter() - t0
    with _blocks(forced=cpu_blocks) as gpu_blocks, _routes() as gpu_routes:
        gpu_out, _ = _lm_greedy(arch, gpu_params, torch.as_tensor(prompt, device="cuda"), tokens)
    free_out, _ = _lm_greedy(arch, gpu_params, torch.as_tensor(prompt, device="cuda"), tokens)
    assert len(gpu_blocks) == len(cpu_blocks) == arch.cfg.n_layers * (LM_CPU_STEPS + 1)
    block_worst = max(_scaled_err(g, c) for (_, g), (_, c) in zip(gpu_blocks, cpu_blocks))
    assert block_worst <= LM_BLOCK_RTOL, \
        f"lm {aid}: a block on the card is {block_worst:.3g} of a row's largest from the CPU's"
    worst, near_ties = 0.0, 0
    for i, (got, want) in enumerate(zip(gpu_out, cpu_out)):
        err = _scaled_err(got, want)
        assert err <= LM_LOGIT_RTOL, f"lm {aid} card vs CPU, call {i}: {err:.3g} of a row's largest"
        worst = max(worst, err)
        ga, ca = got.argmax(-1), want.argmax(-1)
        gap = want.gather(-1, ca[:, None])[:, 0] - want.gather(-1, ga[:, None])[:, 0]
        assert bool(((ga == ca) | (gap <= LM_LOGIT_RTOL * want.abs().amax(-1))).all()), \
            f"lm {aid}: the card's argmax differs off a near-tie at call {i}"
        near_ties += int((ga != ca).sum())
    free = [_scaled_err(g, c) for g, c in zip(free_out, cpu_out)]
    free_same = sum(int((g.argmax(-1) == c.argmax(-1)).sum()) for g, c in zip(free_out, cpu_out))
    line = (f"lm card_vs_cpu {aid} layers={arch.cfg.n_layers} fp32 B={LM_CPU_BATCH} "
            f"prompt={LM_CPU_PROMPT} steps={LM_CPU_STEPS} block_worst={block_worst:.3g} "
            f"(limit {LM_BLOCK_RTOL:g}) logit_worst={worst:.3g} (limit {LM_LOGIT_RTOL:g}) "
            f"argmax_near_ties={near_ties} free_run_logit_err="
            f"{'/'.join(f'{e:.2g}' for e in free)} free_run_argmax_equal={free_same} of "
            f"{LM_CPU_BATCH * len(free)} cpu_s={cpu_s:.1f}")
    if arch.cfg.is_moe:
        assert len(gpu_routes) == len(cpu_routes) > 0, (len(gpu_routes), len(cpu_routes))
        ties = 0
        for (gi, _, _), (ci, kth, nxt) in zip(gpu_routes, cpu_routes):
            differ = (gi != ci).any(-1)
            assert bool((~differ | (kth - nxt <= 1e-5 * kth)).all()), \
                f"lm {aid}: expert choices differ off a tie"
            ties += int(differ.sum())
        line += f" route_calls={len(cpu_routes)} tokens_routed_differently_at_ties={ties}"
    log(line)
    del gpu_params, cpu_params, cpu_blocks, gpu_blocks
    gc.collect()
    torch.cuda.empty_cache()


def phase_lm_example() -> int:
    """(c) examples/lm_decode_torch.py at its defaults on the card (its
    assertion: decode's argmax equal to the full forward's at every checked
    step) and on the CPU: the same tokens.  Returns its fp32 launches."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import lm_decode_torch as example
    finally:
        sys.path.remove(str(ROOT / "examples"))
    card = example.main(["--device", "cuda"])
    with uncounted():
        cpu = example.main(["--device", "cpu"])
    assert np.array_equal(card["tokens"], cpu["tokens"]), "example: the card's tokens differ"
    log(f"lm example tokens_equal_to_cpu=True max_rel_err card={card['max_err']:.3g} "
        f"cpu={cpu['max_err']:.3g}")
    return 6 * (1 + 16 + 4)  # prefill, 16 steps, 4 forward checks, 6 layers each


def phase_lm() -> dict:
    """Phase 10: the LM family on the card; returns the launches of (a) and
    (c).  Every prefill and decode step of an LM layer is one flash_attn
    launch, so the counts are held to the calls made: no LM path ran the
    plain attention."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    log(f"lm phase: {_gib(torch.cuda.memory_allocated()):.2f} GiB held by earlier phases")
    t0 = time.perf_counter()
    with uncounted():
        phase_lm_kernels(torch.Generator(device="cuda").manual_seed(10))
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    _zero_counts()
    phase_lm_cells()
    layers = {aid: _lm_cut(aid, LM_CUTS[aid][0]).cfg.n_layers for aid in LM_ARCHS}
    bf16_calls = sum(2 * LM_PREFILL_LAYERS.get(aid, layers[aid])  # warm-up and timed prefill
                     + layers[aid] * LM_DECODE_STEPS * (2 if aid == "gemma3-12b" else 1)
                     for aid in LM_ARCHS)
    f32_calls = phase_lm_example()
    counts = _read_counts()
    t2 = time.perf_counter()
    with uncounted():
        for aid in LM_ARCHS:
            phase_lm_cpu(aid)
    log(f"lm phase: kernels {t1 - t0:.1f} s, cells and example {t2 - t1:.1f} s, card vs CPU "
        f"{time.perf_counter() - t2:.1f} s; launches={counts} (bf16 calls {bf16_calls}, "
        f"fp32 calls {f32_calls})")
    assert counts["flash_attn_bf16"] == bf16_calls and counts["flash_attn"] == f32_calls, \
        f"lm: attention ran other than one flash_attn launch a layer call: {counts}"
    _assert_path("lm", counts, ("flash_attn", "flash_attn_bf16"))
    return counts


# ----------------------------------------------------------------- phase 11
# train_4k (seq 4,096, published batch 256) at the published widths, bf16
# weights and gradients, fp32 AdamW moments (12 bytes a parameter before any
# activation): arch -> (layers or None, batch).  Each batch is the largest
# whose peak, extrapolated from a run at a smaller one (the
# "batch_that_fits" each cell logs, or measured), peaks at about 65 GiB:
# granite at B 32 (extrapolated to 70 GiB from B 4) ran out of memory at
# 71.4 GiB held and a 6.0 GiB logits chunk asked for, 10% past the
# extrapolation, so the cuts keep that margin under CARD_GIB (PERF.md §4).
# grok's one layer holds 6.53 B parameters, 73.0 GiB at 12 bytes: its cell
# builds and is not stepped.  The mesh tools do not make it fit one card:
# a mesh has one rank here, and the dry-run (phase 14) states what one rank
# of a 256-card mesh would hold.
# granite fits whole at B 24 (64.79 GiB, PERF.md §4) and is timed at a
# tenth of its layers, its 8.2 s steps at full depth being the longest of
# the phase: the run's time limit pays for phases 12, 13 (h)-(i) and 14.
# gemma is timed at one 5:1 pattern cycle (two fit at B 4: 65.17 GiB).  internlm2
# fits 8 layers at B 10 (65.13 GiB) and is timed at 2, which pays for
# phase 13.
LM_TRAIN_CUTS = {"granite-3-2b": (4, 24),
                 "gemma3-12b": (6, 4),
                 "internlm2-20b": (2, 10),
                 "qwen3-moe-235b-a22b": (1, 9),
                 "grok-1-314b": (1, None)}
LM_TRAIN_STEPS = 3
TRAIN_BYTES_PER_PARAM = 12  # bf16 weights and gradients, fp32 mu and nu
# (a) the backward against its plain version on the same inputs (q, k, v,
# the forward kernel's out and lse, a seeded dout), per output tensor:
# |got - want| <= rtol |want| + atol * max |want|.  fp32: atol 1e-4 (the
# sums' order and exp2 against exp).  bf16: rtol 2**-7, the two outputs'
# roundings to bf16 (2**-8 of a value each), and atol 2**-8: a ds that lies
# at a bf16 rounding boundary rounds the other way in one of the two, which
# moves one term of a sum by an ulp of that term.
FLASH_BWD_TOL = {"float32": (0.0, 1e-4), "bfloat16": (2**-7, 2**-8)}
LSE_ATOL = 1e-4  # (a): the forward's lse against the plain version's on fp32 values
# (a) edges: (B, S, T, H, KV, hd, q_offset, window), fp32 and bf16
FLASH_BWD_EDGES = {"ragged_s": (2, 1000, 1000, 4, 2, 128, 0, None),
                   "hd32": (2, 300, 300, 4, 2, 32, 0, None),
                   "hd256": (1, 500, 500, 4, 2, 256, 0, None),
                   "g1": (2, 300, 300, 4, 4, 64, 0, None),
                   "window_17": (2, 700, 700, 8, 2, 64, 0, 17),
                   "q_offset": (1, 200, 600, 4, 2, 64, 400, None),
                   "rows_without_keys": (1, 64, 100, 2, 1, 64, 110, 20),
                   # the mask's edges again at hd 256 (x3m's fp32 tiles: 32 rows)
                   "hd256_window_17": (1, 300, 300, 4, 2, 256, 0, 17),
                   "hd256_q_offset": (1, 200, 600, 4, 2, 256, 400, None),
                   "hd256_rows_without_keys": (1, 64, 100, 2, 1, 256, 110, 20)}
# (a) the train shapes, from each arch's attention and its LM_TRAIN_CUTS batch
FLASH_BWD_CELLS = {"granite": ("granite-3-2b", None), "gemma_local": ("gemma3-12b", 1024),
                   "gemma_global": ("gemma3-12b", None), "internlm2": ("internlm2-20b", None),
                   "qwen3": ("qwen3-moe-235b-a22b", None)}
# fp32 too: one cell for each tiling of the fp32 kernels (x3 at hd 64, x3m at
# hd 128 and 256)
FLASH_BWD_F32_CELLS = ("granite", "internlm2", "gemma_global")
PLAIN_KV_CHUNK = 256     # the plain backward's keys a step on the card
# (c) card against CPU: one pattern cycle of each arch at the published
# widths, fp32, batch 1, 256 tokens, loss_chunk 128: LM_CPU_LAYERS, but
# qwen3's cycle is its one layer (phase 10 takes two), which keeps its fp32
# gradients beside its weights within the host's memory
LM_TRAIN_CPU = dict(batch=1, seq=256, loss_chunk=128)
LM_TRAIN_CPU_LAYERS = {**LM_CPU_LAYERS, "qwen3-moe-235b-a22b": 1}
LM_LOSS_RTOL = 1e-5
# (c): a random model at these widths is chaotic in fp32: the CPU's own
# fp32 gradient is up to 2.4e-3 (granite) to 1.6 (gemma) of a leaf's
# largest from a float64 run (scripts/lm_grad_conditioning.py on the card's
# host), so the free run is logged, and each block's VJP (its input's and
# its parameters' gradients) is held on the CPU run's input and output
# cotangent, as phase 10 (b) holds the blocks' outputs, and the head
# (final norm, cross-entropy) on the CPU run's last hidden state.  Limits,
# relative to a leaf's largest |value|: one fp32 block VJP is up to 3.5e-4
# from float64 (gemma) and the card and the CPU each carry such an error;
# the head's fp32 gradients are up to 3.3e-5 from float64 (gemma's
# unembedding), and the card sums its 262,144-long products in another
# order than the CPU (1.6e-4 apart; PERF.md).
LM_BLOCK_GRAD_RTOL = 1e-3
LM_HEAD_GRAD_RTOL = 5e-4
# (c): a MoE block's VJP on the card takes the CPU run's expert choices; its
# own may differ only where the router's k-th and k+1-th probs lie within
# this of each other: the router reads the block's attention output, which
# is the card's own to about 2.5e-4 of a row's largest (LM_BLOCK_RTOL), and
# moves a router logit by about 1e-3
ROUTE_TIE_RTOL = 2e-3
# (c) the bf16 head product's VJP (what train_4k's loss runs on the card),
# card against CPU on HEAD_BF16_ROWS rows, per tensor:
# |got - want| <= rtol |want| + atol max |want|.  The logits are fp32 sums of
# bf16 products (the sums' order: atol 1e-5).  dx and d unembed are fp32
# sums rounded once to bf16, as JAX rounds them: two sums a little apart
# round to neighbouring bf16 values across a boundary, one ulp, at most
# 2**-7 of a value (rtol), and 1e-5 of the largest for the sums' order.
HEAD_BF16_TOL = {"float32": (0.0, 1e-5), "bfloat16": (2**-7, 1e-5)}
HEAD_BF16_ROWS = 16
# (d) the train launcher's LM branch on the card against its CPU run
LM_LAUNCHER_ARGS = ["--arch", "granite-3-2b", "--steps", "4", "--batch", "4"]
LM_LAUNCHER_RTOL = 1e-4
TRAIN_KERNELS = ("flash_attn", "flash_attn_bf16", "flash_attn_bwd", "flash_attn_bwd_bf16")


def _bwd_shape(cell: str):
    """(B, S, T, H, KV, hd, q_offset, window) of a train attention call."""
    aid, window = FLASH_BWD_CELLS[cell]
    cfg = _lm_cut(aid).cfg
    s = 4096
    return (LM_TRAIN_CUTS[aid][1], s, s, cfg.n_heads, cfg.n_kv, cfg.head_dim, 0, window)


def _sdpa_bwd(q, k, v, dout, q_offset: int, window):
    """The library yardstick: the backward of one scaled_dot_product_attention
    call on the same inputs.  bf16 groups its heads by ``enable_gqa`` (the
    flash backend); fp32 takes k and v repeated to H heads inside the graph
    (the memory-efficient backend, which builds no [S, T] matrix and has no
    fp32 GQA: ``enable_gqa`` sends fp32 to the math backend, whose [B, H, S,
    S] scores do not fit at the train shapes), so its backward also sums dk
    and dv over each group."""
    import torch
    import torch.nn.functional as F

    qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    mask = _sdpa_mask(q, k, q_offset, window)
    gqa = q.dtype == torch.bfloat16
    g = 1 if gqa else q.shape[2] // k.shape[2]
    kx, vx = (x.repeat_interleave(g, dim=1) for x in (kh, vh))
    out = F.scaled_dot_product_attention(qh, kx, vx, attn_mask=mask, is_causal=mask is None,
                                         enable_gqa=gqa)
    do = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qh, kh, vh), do, retain_graph=True)


def _check_bwd(name: str, got, want, dtype) -> float:
    """Each of dq, dk, dv finite and within FLASH_BWD_TOL of the plain
    version's; returns the largest error over the tensor's largest |value|."""
    import torch

    rtol, atol = FLASH_BWD_TOL[str(dtype).split(".")[-1]]
    worst = 0.0
    for label, a, w in zip(("dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(a).all()), f"flash_attn_bwd {name}: {label} not finite"
        a, w = a.float(), w.float()
        top = float(w.abs().max())
        diff = (a - w).abs()
        bad = diff > rtol * w.abs() + atol * top
        worst = max(worst, float(diff.max()) / max(top, 1e-30))
        assert not bool(bad.any()), (f"flash_attn_bwd {name}: {label} has {int(bad.sum())} "
                                     f"values outside rtol={rtol:g} atol={atol:g} of its "
                                     f"largest, max err {float(diff.max()):.3g} of {top:.3g}")
    return worst


def check_flash_bwd_cell(name: str, shape, dtype, g, timed: bool = False) -> dict:
    """The forward kernel with lse (lse against the plain version's on fp32
    values) and the backward kernel against flash_attention_bwd_ref on the
    same inputs (FLASH_BWD_TOL); two runs bit-identical; rows with no key
    get zero gradients.  ``timed``: ms (the backward's three kernels a call,
    by CUDA events), plain_ms, SDPA's backward and the bound."""
    import torch

    from repro_torch.kernels.flash_attn import (flash_attention_bwd, flash_attention_bwd_ref,
                                                flash_attention_fwd_ref)
    from repro_torch.kernels.flash_attn import ops
    from repro_torch.kernels.flash_attn.ops import (BWD_FLOPS_PER_PAIR, TF32_PASSES,
                                                    backward_cost, causal_pairs)

    b, s, t, h, kv, hd, off, win = shape
    dname = str(dtype).split(".")[-1]
    q, k, v = _flash_inputs(shape, dtype, g)
    dout = torch.randn((b, s, h, hd), generator=g, device="cuda").to(dtype)
    out, lse, res = ops._forward_kernel(q, k, v, off, win, with_lse=True)
    if dtype == torch.bfloat16:  # the residual is what out was rounded from
        assert torch.equal(res.to(dtype), out), f"flash_attn {name}: residual is not out's source"
    lse_err = None
    if not timed:
        _, want_lse = flash_attention_fwd_ref(q.float(), k.float(), v.float(), q_offset=off,
                                              window=win)
        seen = torch.isfinite(want_lse)
        assert bool((torch.isfinite(lse) == seen).all()), f"lse {name}/{dname}: -inf rows differ"
        lse_err = float((lse - want_lse)[seen].abs().max()) if bool(seen.any()) else 0.0
        assert lse_err <= LSE_ATOL, f"lse {name}/{dname}: {lse_err:.3g} from the plain version"
    run = lambda: flash_attention_bwd(q, k, v, res, dout, lse, q_offset=off, window=win)  # noqa
    got = run()
    again = run()
    want = flash_attention_bwd_ref(q, k, v, res, dout, lse, q_offset=off, window=win,
                                   kv_chunk=PLAIN_KV_CHUNK)
    torch.cuda.synchronize()
    same = all(torch.equal(a, w) for a, w in zip(got, again))
    assert same, f"flash_attn_bwd {name}/{dname}: two runs differ"
    err = _check_bwd(f"{name}/{dname}", got, want, dtype)
    empty = _rows_without_keys(s, t, off, win)
    assert bool((got[0][:, empty] == 0).all()), f"flash_attn_bwd {name}: a row with no key moved"
    del want, again
    torch.cuda.empty_cache()
    result = dict(max_abs_err=err)
    line = (f"kernel=flash_attn_bwd {'cell' if timed else 'edge'}={name} dtype={dname} B={b} "
            f"S={s} T={t} H={h} KV={kv} hd={hd} q_offset={off} window={win} "
            f"err_of_largest={err:.3g} (rtol, atol={FLASH_BWD_TOL[dname]}) deterministic=True"
            + ("" if lse_err is None else f" lse_err={lse_err:.3g}")
            + f" rows_without_keys={int(empty.sum())}")
    if timed:
        # CUDA events: a call is 40-300 ms of the card's time, so the host's
        # share is nil, and in a long process torch.profiler's sessions lose
        # these launches' events (8 sessions in a row at gemma's global cell)
        ms = cuda_ms(run, reps=3, warmup=1)
        plain_ms = cuda_ms(lambda: flash_attention_bwd_ref(q, k, v, res, dout, lse, q_offset=off,
                                                           window=win, kv_chunk=PLAIN_KV_CHUNK),
                           reps=1, warmup=1)
        torch.cuda.empty_cache()
        library_ms = cuda_ms(_sdpa_bwd(q, k, v, dout, off, win), reps=3, warmup=1)
        torch.cuda.empty_cache()
        # q, dout, dq, and the fp32 residual; k, v, dk, dv; lse
        flops, nbytes = backward_cost(b, s, t, h, kv, hd, off, win, q.element_size())
        pairs = causal_pairs(s, t, off, win) * b * h
        if dtype == torch.float32:  # 3xTF32 on the tensor cores; the fp32 units' bound beside
            passes, rate = TF32_PASSES, TF32_FLOP_PER_S
            fma_ms, _ = bound(nbytes, flops, FP32_FLOP_PER_S)
            beside = f" fp32_fma_bound_ms={fma_ms:.4f}"
            result.update(fp32_fma_bound_ms=fma_ms)
        else:
            passes, rate, beside = 1, BF16_FLOP_PER_S, ""
        bound_ms, by = bound(nbytes, passes * flops, rate)
        result.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                      bound_by=by)
        line += (f" pairs={pairs:.4g} ms={ms:.3f} plain_ms={plain_ms:.3f} (both CUDA events) "
                 f"library_ms={library_ms:.3f} (SDPA backward, CUDA events) "
                 f"bound_ms={bound_ms:.4f} bound_by={by} (rate {rate / 1e12:.0f} TFLOP/s, "
                 f"{passes} x {BWD_FLOPS_PER_PAIR} hd flops a pair){beside} "
                 f"share_of_bound={bound_ms / ms:.4f} "
                 f"tflops_at_14hd={passes * 14 * hd * pairs / ms / 1e9:.2f}"
                 + (" (tf32 flops: 3 passes)" if passes > 1 else ""))
    log(line)
    del q, k, v, dout, out, lse, res, got
    torch.cuda.empty_cache()
    return result


def phase_lm_train_kernels(g) -> dict:
    """(a) The backward kernel at its edges (fp32 and bf16) and at each
    train cell's attention (bf16; FLASH_BWD_F32_CELLS' also fp32),
    each timed beside its plain version, SDPA's backward and its bound.
    Returns the timings of the kernels line (granite's attention)."""
    import torch

    for cell, shape in FLASH_BWD_EDGES.items():
        for dtype in (torch.float32, torch.bfloat16):
            check_flash_bwd_cell(cell, shape, dtype, g)
    out = {}
    for cell in FLASH_BWD_CELLS:
        dtypes = ((torch.float32, torch.bfloat16) if cell in FLASH_BWD_F32_CELLS
                  else (torch.bfloat16,))
        for dtype in dtypes:
            res = check_flash_bwd_cell(cell, _bwd_shape(cell), dtype, g, timed=True)
            if cell == "granite":
                out["flash_attn_bwd" if dtype == torch.float32 else "flash_attn_bwd_bf16"] = res
    return out


def _grad_norms(params, batch, cfg) -> tuple:
    """The norm of lm_loss's gradient at ``params`` on ``batch``, by one
    value_and_grad outside the train step: (the fp32 norm the optimizer
    clips by, JAX's formula, whose sum of squares overflows past 1.8e19 a
    leaf element; the same norm formed without overflow, each leaf scaled
    by its largest |value| and the squares summed in float64)."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer, value_and_grad
    from repro_torch.train.tree import leaves

    _, grads = value_and_grad(tf.lm_loss)(params, batch, cfg)
    total = 0.0
    for g in leaves(grads):
        top = g.abs().amax().float().clamp_min(1e-30)
        total += float((top.double() * torch.linalg.vector_norm(g.float() / top).double()) ** 2)
    return float(optimizer.global_norm(grads)), total ** 0.5


KERNEL_GROUPS = (("attn_fwd", ("flash_attn_bf16_kernel", "flash_attn_f32_kernel")),
                 ("attn_bwd", ("dkv_kernel", "dq_kernel", "delta_kernel")),
                 ("gemm", ("gemm", "cutlass", "sm90_", "xmma", "nvjet")))


def _train_breakdown(name: str, step, kernel_groups=KERNEL_GROUPS) -> None:
    """Where one profiled train step's device time goes: by
    ``kernel_groups`` (flash_attn forward, its backward, matrix products),
    the rest; the largest kernels; the idle share of the step's wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    groups = {name: 0.0 for name, _ in kernel_groups}
    groups["other"] = 0.0
    for e in kernels:
        key = e.key.lower()
        group = next((gname for gname, words in kernel_groups
                      if any(w.lower() in key for w in words)), "other")
        groups[group] += e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"train breakdown {name}: busy_ms={total:.1f} wall_ms(profiled)={wall:.1f} "
        f"idle_share={max(0.0, 1 - total / wall):.3f} "
        + " ".join(f"{k}_ms={v:.1f} ({v / max(total, 1e-9):.3f})" for k, v in groups.items())
        + " top: " + "; ".join(f"{e.key[:50]} x{e.count} {e.self_device_time_total / 1e3:.1f}ms"
                               for e in top))


def _train_batch(vocab: int, b: int, s: int, g) -> dict:
    import torch

    toks = torch.randint(0, vocab, (b, s + 1), generator=g, device="cuda", dtype=torch.int32)
    return {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}


def _model_flops(cfg, b: int, s: int) -> float:
    """A train step's model flops: 6 N_active a token for the matrices and,
    for attention, 3 x 4 hd a (query, key) pair in the mask, a head."""
    from repro_torch.kernels.flash_attn.ops import causal_pairs

    pairs = sum(causal_pairs(s, s, 0, w) for w in cfg.window_pattern) * cfg.n_rep
    return 6.0 * cfg.active_param_count() * b * s + 12.0 * cfg.head_dim * cfg.n_heads * pairs * b


def phase_lm_train_cell(aid: str, g) -> int:
    """(b) train_4k through LMArch.build_cell at the published widths cut by
    LM_TRAIN_CUTS: LM_TRAIN_STEPS steps, the last under sync debug mode
    "error" (ms a step as the mean of steps 2-3, tokens/s, model-flops
    share of 989 TFLOP/s, peak memory, the losses finite), all of the cell's
    step as it stands, the first (outside the mean) profiled for its
    breakdown; then the gradient norm (finite) by a value_and_grad of its
    own.  Returns the layer calls that needed a gradient (one backward
    launch each)."""
    import torch

    from repro_torch.train import adamw_init
    from repro_torch.train.tree import leaves

    layers, batch = LM_TRAIN_CUTS[aid]
    arch = _lm_cut(aid, layers)
    cfg = arch.cfg
    cell = arch.build_cell("train_4k")
    s = cell.args[2]["tokens"].shape[1]
    n_params = sum(t.numel() for t in leaves(cell.args[0]))
    if batch is None:
        log(f"lm {cell.name} layers={cfg.n_layers} params={n_params} state_gib="
            f"{_gib(TRAIN_BYTES_PER_PARAM * n_params):.2f} at {TRAIN_BYTES_PER_PARAM} B a "
            f"parameter (bf16 weights and gradients, fp32 moments) before any activation: does "
            f"not fit one card (CARD_GIB {CARD_GIB}); not stepped (a mesh has one rank on "
            f"this card); meta={cell.meta}")
        return 0
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = arch.init(g, device="cuda")
    state = [params, adamw_init(params)]
    torch.cuda.synchronize()
    weights = sum(t.numel() * t.element_size() for t in leaves(params))
    fixed = weights + sum(t.numel() * t.element_size() for t in leaves(state))  # and gradients
    init_s = time.perf_counter() - t0
    batches = [_train_batch(cfg.vocab, batch, s, g) for _ in range(LM_TRAIN_STEPS)]
    del params

    def step(i):
        state[0], state[1], loss = cell.step_fn(state[0], state[1], batches[i])
        return loss

    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for i in range(LM_TRAIN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if i == LM_TRAIN_STEPS - 1:  # a read-back in the step would raise
            torch.cuda.set_sync_debug_mode("error")
        try:
            if i == 0:
                _train_breakdown(cell.name, lambda: losses.append(step(0)))
            else:
                losses.append(step(i))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    MEASURED_PEAKS[aid] = (layers, batch, peak - base)
    with uncounted():
        clip_norm, grad_norm = _grad_norms(state[0], batches[-1], cfg)
    losses = [float(x) for x in losses]
    assert all(x == x and abs(x) < float("inf") for x in losses + [grad_norm]), \
        f"{cell.name}: loss or gradient not finite: {losses} {grad_norm}"
    ms = sum(walls[1:]) / len(walls[1:])
    flops = _model_flops(cfg, batch, s)
    log(f"lm {cell.name} layers={cfg.n_layers} of {_lm_cut(aid).cfg.n_layers} B={batch} S={s} "
        f"params={n_params} weights_gib={_gib(weights):.2f} state_and_grads_gib="
        f"{_gib(fixed):.2f} init_s={init_s:.1f} "
        f"steps_ms={'/'.join(f'{w:.1f}' for w in walls)} ms_per_step={ms:.1f} "
        f"tokens_per_s={batch * s / ms * 1e3:.0f} model_tflop={flops / 1e12:.2f} "
        f"mfu={flops / (ms / 1e3) / BF16_FLOP_PER_S:.4f} (of 989 TFLOP/s bf16) "
        f"peak_gib={_gib(peak):.2f} batch_that_fits~{_fits(peak, fixed, batch)} "
        f"losses={'/'.join(f'{x:.4f}' for x in losses)} "
        f"grad_norm={grad_norm:.4g} (float64 sums; a value_and_grad after the timed steps) "
        f"optimizer_fp32_norm={clip_norm:.4g} "
        f"last_step_sync_debug=error")
    del state, batches
    gc.collect()
    torch.cuda.empty_cache()
    # the counted steps (not the profiled one): one backward a layer
    return cfg.n_layers * LM_TRAIN_STEPS


def _rel_err(got, want) -> float:
    """max |got - want| over the largest |want|, on ``got``'s device."""
    want = want.to(got.device)
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def _check_head_bf16(aid: str, x, unembed) -> str:
    """(c) The bf16 head product (``matmul_f32``: the logits of bf16 hidden
    states against the bf16 unembedding, fp32 out) and its VJP for a seeded
    fp32 cotangent, on the card (one bf16 GEMM forward, ``_MatmulF32``'s
    backward) against the CPU (autograd of the fp32 product of the same
    bf16 values), at the arch's published width and vocab: the logits
    within HEAD_BF16_TOL's fp32 limit, dx and d unembed (each an fp32 sum
    rounded once to bf16) within its bf16 one.  ``x`` [rows, d] and
    ``unembed`` [d, V] are the CPU run's, rounded to bf16."""
    import torch

    from repro_torch.models import layers as L

    a, b = x.detach().bfloat16(), unembed.detach().bfloat16()
    cot = torch.randn((a.shape[0], b.shape[1]), generator=torch.Generator().manual_seed(5))
    res = {}
    for dev in ("cuda", "cpu"):
        ad, bd = (t.to(dev).requires_grad_(True) for t in (a, b))
        out = L.matmul_f32(ad, bd)
        grads = torch.autograd.grad(out, (ad, bd), cot.to(dev))
        res[dev] = [t.to("cuda") for t in (out.detach(), *grads)]  # compared on the card
        fn = out.grad_fn
        while type(fn).__name__ == "ViewBackward0":
            fn = fn.next_functions[0][0]
        assert dev != "cuda" or type(fn).__name__ == "_MatmulF32Backward", type(fn)
        del ad, bd, out, grads
    errs = []
    for label, got, want in zip(("logits", "dx", "dunembed"), res["cuda"], res["cpu"]):
        rtol, atol = HEAD_BF16_TOL["float32" if label == "logits" else "bfloat16"]
        got, want = got.float(), want.float()
        assert got.dtype == want.dtype and bool(torch.isfinite(got).all())
        diff = (got - want).abs()
        top = float(want.abs().max())
        assert bool((diff <= rtol * want.abs() + atol * top).all()), \
            f"lm train {aid}: the bf16 head's {label} {float(diff.max()):.3g} of {top:.3g}"
        errs.append(f"{label}:{float(diff.max()) / top:.3g}")
    return "/".join(errs) + f" (rows {a.shape[0]}, limits {HEAD_BF16_TOL})"


def phase_lm_train_cpu(aid: str) -> None:
    """(c) lm_loss's gradient at the published widths, one pattern cycle
    (LM_TRAIN_CPU_LAYERS), fp32, LM_TRAIN_CPU's batch, on the card against
    the CPU on the same weights and tokens: each block's VJP on the CPU
    run's block input and output cotangent within LM_BLOCK_GRAD_RTOL of a
    leaf's largest |value| (the CPU's own VJP is its run's: the gradients
    of the block's input and of its slice of each stacked leaf; a MoE
    block's card VJP takes the CPU run's expert choices, which may differ
    from its own only where the router's k-th and k+1-th probs tie within
    ROUTE_TIE_RTOL); the head's loss within LM_LOSS_RTOL and its
    gradients within LM_HEAD_GRAD_RTOL on the CPU's last hidden state; the
    free run (the card's whole value_and_grad, remat on, against the CPU's)
    logged."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as tf
    from repro_torch.train import value_and_grad
    from repro_torch.train.tree import leaves, named_leaves, tree_map

    sys.path.insert(0, str(ROOT / "scripts"))
    try:  # the float64 study's block, head and routing helpers
        from lm_grad_conditioning import block_vjp, captured_blocks, forced_route, head_vjp
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    arch = _lm_cut(aid, LM_TRAIN_CPU_LAYERS[aid], torch.float32)
    cfg = dataclasses.replace(arch.cfg, loss_chunk=LM_TRAIN_CPU["loss_chunk"])
    gpu = arch.init(torch.Generator(device="cuda").manual_seed(4), device="cuda")
    cpu = tree_map(lambda t: t.cpu(), gpu)
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab, (LM_TRAIN_CPU["batch"], LM_TRAIN_CPU["seq"] + 1)).astype(np.int32)
    batch = {"tokens": torch.as_tensor(toks[:, :-1]), "labels": torch.as_tensor(toks[:, 1:])}
    t0 = time.perf_counter()
    with captured_blocks() as seen, _routes() as routes:
        own = [p.requires_grad_(True) for p in leaves(cpu)]
        cpu_loss = tf.lm_loss(cpu, batch, dataclasses.replace(cfg, remat=False))
        cpu_loss.backward()
    cpu_loss = cpu_loss.detach()
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss, grads = value_and_grad(tf.lm_loss)(
        gpu, {k: v.to("cuda") for k, v in batch.items()}, cfg)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    free = {n: _rel_err(g, p.grad) for (n, g), p in zip(named_leaves(grads), own)}
    free_loss = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
    del grads
    torch.cuda.empty_cache()

    blocks, ties = [], 0
    stacked = [p.grad.flatten(0, 1) for p in leaves(cpu["blocks"])]
    for i, ((x, y), (_, _, window, bp_gpu)) in enumerate(zip(seen, tf._layers(gpu, cfg))):
        want = [x.grad] + [g[i] for g in stacked]
        forced = forced_route(routes[i][0]) if cfg.is_moe else contextlib.nullcontext()
        with forced as route:
            got = block_vjp(bp_gpu, x.detach().to("cuda"), y.grad.to("cuda"), cfg, window)
        if cfg.is_moe:
            _, kth, nxt = routes[i]
            gap = ((kth - nxt) / kth)[route.differ]
            assert bool((gap <= ROUTE_TIE_RTOL).all()), \
                f"lm train {aid}: the card's expert choices differ off a tie: gaps {gap.tolist()}"
            ties += int(route.differ.sum())
        blocks.append(max(_rel_err(a, b) for a, b in zip(got, want)))
        del got
    del stacked
    for p in own:
        p.grad = None
        p.requires_grad_(False)
    gc.collect()
    unembed = lambda p: p["embed"].T if cfg.tied_embed else p["unembed"]  # noqa: E731
    last = seen[-1][1].detach()
    del seen
    want_loss, want = head_vjp(last, cpu["final_ln"], unembed(cpu), batch["labels"], cfg)
    got_loss, got = head_vjp(last.to("cuda"), gpu["final_ln"], unembed(gpu),
                             batch["labels"].to("cuda"), cfg)
    head = max(_rel_err(a, b) for a, b in zip(got, want))
    head_loss = abs(float(got_loss) - float(want_loss)) / abs(float(want_loss))
    bf16_head = _check_head_bf16(aid, L.rmsnorm(last, cpu["final_ln"])[0, :HEAD_BF16_ROWS],
                                 unembed(cpu))
    worst = max(free, key=free.get)
    log(f"lm train card_vs_cpu {aid} layers={cfg.n_layers} fp32 B={LM_TRAIN_CPU['batch']} "
        f"S={LM_TRAIN_CPU['seq']} loss_chunk={cfg.loss_chunk} block_vjp_worst="
        f"{'/'.join(f'{e:.3g}' for e in blocks)} (limit {LM_BLOCK_GRAD_RTOL:g}) head_loss_rel_err="
        f"{head_loss:.3g} (limit {LM_LOSS_RTOL:g}) head_grad_worst={head:.3g} (limit "
        f"{LM_HEAD_GRAD_RTOL:g}) bf16_head_vjp={bf16_head} free_run_loss_rel_err={free_loss:.3g} "
        f"free_run_worst_leaf={worst} "
        f"{free[worst]:.3g} tokens_routed_differently_at_ties={ties} card_s={card_s:.1f} "
        f"cpu_s={cpu_s:.1f} free_run: "
        + " ".join(f"{n.replace(chr(39), '')}={e:.2g}" for n, e in free.items()))
    assert max(blocks) <= LM_BLOCK_GRAD_RTOL, \
        f"lm train {aid}: a block's VJP on the card is {max(blocks):.3g} of a leaf's largest"
    assert head_loss <= LM_LOSS_RTOL and head <= LM_HEAD_GRAD_RTOL, \
        f"lm train {aid}: the head's loss {head_loss:.3g} or gradients {head:.3g} off the CPU's"
    del gpu, cpu, own
    gc.collect()
    torch.cuda.empty_cache()


def phase_lm_train_launcher() -> int:
    """(d) python -m repro_torch.launch.train with an LM id on the card
    (fp32: the fp32 forward and backward kernels) and on the CPU: each
    step's loss within LM_LAUNCHER_RTOL relative.  Returns its layer calls
    that needed a gradient."""
    from repro_torch.launch import train

    card = train.main(LM_LAUNCHER_ARGS)
    with uncounted():
        cpu = train.main(LM_LAUNCHER_ARGS + ["--device", "cpu"])
    got = [h["loss"] for h in card.history]
    want = [h["loss"] for h in cpu.history]
    errs = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    log(f"lm train launcher {' '.join(LM_LAUNCHER_ARGS)}: card losses "
        f"{'/'.join(f'{x:.6f}' for x in got)} cpu {'/'.join(f'{x:.6f}' for x in want)} "
        f"worst_rel_err={max(errs):.3g} (limit {LM_LAUNCHER_RTOL:g})")
    assert len(got) == len(want) and max(errs) <= LM_LAUNCHER_RTOL, (got, want)
    cfg = train._tiny_lm(_lm_cut(LM_LAUNCHER_ARGS[1]).cfg)
    return cfg.n_layers * len(got)


def phase_lm_train() -> tuple:
    """Phase 11: LM training on the card.  Returns (the launches of (b), (c)
    and (d), the backward kernels' timings for the kernels line).  In (b)
    and (d) every layer call that needs a gradient is one backward launch
    and, under remat, two forward launches (bf16, (b)); without remat one
    ((d), fp32)."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    log(f"lm train phase: {_gib(torch.cuda.memory_allocated()):.2f} GiB held by earlier phases")
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(11)
    with uncounted():
        timings = phase_lm_train_kernels(g)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    _zero_counts()
    bf16_calls = sum(phase_lm_train_cell(aid, g) for aid in LM_TRAIN_CUTS)
    f32_calls = phase_lm_train_launcher()
    counts = _read_counts()
    want = {"flash_attn_bwd_bf16": bf16_calls, "flash_attn_bf16": 2 * bf16_calls,
            "flash_attn_bwd": f32_calls, "flash_attn": f32_calls}
    assert all(counts[n] == want[n] for n in want), \
        f"lm train: attention ran other than its kernels once a layer call: {counts} {want}"
    t2 = time.perf_counter()
    for aid in LM_ARCHS:  # (c): the fp32 block VJPs and free runs launch on the main path too
        phase_lm_train_cpu(aid)
    with_c = _read_counts()
    c_launches = {n: with_c[n] - counts[n] for n in TRAIN_KERNELS}
    log(f"lm train phase: kernels {t1 - t0:.1f} s, cells and launcher {t2 - t1:.1f} s, card vs "
        f"CPU {time.perf_counter() - t2:.1f} s; launches of (b) and (d)="
        f"{ {n: counts[n] for n in TRAIN_KERNELS} } (bf16 layer calls with a gradient "
        f"{bf16_calls}, fp32 {f32_calls}); of (c)={c_launches}")
    assert c_launches["flash_attn_bwd"] > 0, f"lm train (c): no fp32 backward launch: {c_launches}"
    _assert_path("lm train", with_c, TRAIN_KERNELS)
    return with_c, timings


# ----------------------------------------------------------------- phase 12
# MeshGraphNet's four cells at the published widths (15 layers, d_hidden
# 128, 2-layer MLPs, sum, fp32; TF32 off).  No TPU kernel is on this path:
# message passing is index_add_ on the card (the JAX package's segment_sum,
# plain XLA), so the phase launches no hand-written kernel.
GNN_TRAIN_STEPS = 3
GNN_SEED = 12
# (a) ogb_products cannot train whole on one card: under remat a step keeps
# 16 carries of e (512 B an edge) and one layer's recomputed backward, 16.4
# KB an edge measured (PERF.md §4), 1.0 TB for 61,859,140 edges.  Nodes and
# edges are cut by one factor (the mean degree 25.26 kept), the smallest
# whose peak stays near 65 GiB: 1/15 peaks at 63.03; the other three cells
# run uncut.
GNN_TRAIN_CUTS = {"ogb_products": 15}
# minibatch_lg: 1,024 seeds sampled at fanouts (15, 10) and padded to
# fanout_budget(1024, (15, 10)) = (169,984, 168,960), the cell's shape, from
# a random_csr of Reddit's node count and mean degree (GraphSAGE, Hamilton
# et al. 2017), whose 602 features the cell has; the features gathered by
# node id from a [232,965, 602] table on the card
GNN_SAMPLER = dict(nodes=232_965, degree=492, seeds=1_024, fanouts=(15, 10))
GNN_MOLECULES = (128, 30, 64)  # molecule: graphs, nodes and edges a graph
# (c) full_graph_sm on the card against the CPU, relative to the largest
# |value|: fp32 on the CPU is 1.2e-6 (out), 8e-8 (loss) and up to 5.3e-3 (a
# gradient leaf: node_enc's first weight) from float64 over seeds 0-2
# (scripts/gnn_grad_conditioning.py), and the card and the CPU each carry
# such an error
GNN_OUT_RTOL, GNN_LOSS_RTOL, GNN_GRAD_RTOL = 1e-5, 1e-6, 1.5e-2
GNN_LAUNCHER_ARGS = ["--arch", "meshgraphnet", "--steps", "3"]
GNN_KERNEL_GROUPS = (KERNEL_GROUPS[2], ("index", ("index", "scatter", "gather")))


def _gnn_study():
    """scripts/gnn_grad_conditioning.py: the float64 study whose graph
    recipe and case phase 12 uses."""
    import importlib

    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        return importlib.import_module("gnn_grad_conditioning")
    finally:
        sys.path.remove(str(ROOT / "scripts"))


def _gnn_forward_flops(cfg, n: int, e: int) -> float:
    """fp32 flops of one forward: 2 a multiply-add of every MLP's products
    (81,920 an edge and 65,536 a node a processor layer at d 128)."""
    h, m = cfg.d_hidden, cfg.mlp_layers

    def mlp(d_in, d_out):
        return d_in * h + (m - 1) * h * h + h * d_out

    per_edge = mlp(cfg.d_edge, h) + cfg.n_layers * mlp(3 * h, h)
    per_node = mlp(cfg.d_feat, h) + cfg.n_layers * mlp(2 * h, h) + mlp(h, cfg.out_dim)
    return 2.0 * (per_edge * e + per_node * n)


def _gnn_graph(shape: str, cfg, g, cut: int = 1) -> tuple:
    """(graph on the card, nodes, edges, padding edges, what made it):
    the shape's graph from GNN_SEED, nodes and edges divided by ``cut``."""
    import numpy as np
    import torch

    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.models.sampler import fanout_budget, random_csr, sample_subgraph

    study = _gnn_study()
    graph_edges, random_graph = study.graph_edges, study.random_graph
    sh = GNN_SHAPES[shape]
    n, e = -(-sh["n_nodes"] // cut), -(-sh["n_edges"] // cut)
    rng = np.random.default_rng(GNN_SEED)
    if shape == "molecule":
        k, nm, em = GNN_MOLECULES
        base = (np.arange(k, dtype=np.int32) * nm)[:, None]
        src = (base + rng.integers(0, nm, (k, em))).astype(np.int32).ravel()
        dst = (base + rng.integers(0, nm, (k, em))).astype(np.int32).ravel()
        how = f"{k} disjoint graphs of {nm} nodes and {em} edges, block-diagonal"
        return random_graph(n, src, dst, cfg, g, "cuda"), n, e, 0, how
    if shape == "minibatch_lg":
        sp = GNN_SAMPLER
        t0 = time.perf_counter()
        csr = random_csr(sp["nodes"], sp["degree"], rng)
        t1 = time.perf_counter()
        budget = fanout_budget(sp["seeds"], sp["fanouts"])
        seeds = rng.choice(sp["nodes"], sp["seeds"], replace=False)
        sub = sample_subgraph(csr, seeds, sp["fanouts"], rng, pad_to=budget)
        t2 = time.perf_counter()
        assert budget == (n, e), (budget, n, e)
        graph = random_graph(n, sub["src"], sub["dst"], cfg, g, "cuda")
        table = torch.randn((sp["nodes"], cfg.d_feat), generator=g, device="cuda")
        graph["node_feat"] = table[torch.as_tensor(sub["node_ids"], device="cuda")]
        del table
        how = (f"sampled from a random_csr of {sp['nodes']} nodes, {len(csr.indices)} indices "
               f"({csr.indices.nbytes / 2**30:.2f} GiB; {t1 - t0:.1f} s): {sp['seeds']} seeds, "
               f"fanouts {sp['fanouts']}, {sub['n_nodes']} nodes and {sub['n_edges']} edges "
               f"before padding ({t2 - t1:.1f} s)")
        return graph, n, e, e - sub["n_edges"], how
    t0 = time.perf_counter()
    src, dst, pad = graph_edges(n, e, GNN_SEED)
    how = (f"random_csr({n}, {-(-e // n)}), edges v -> u, {time.perf_counter() - t0:.1f} s on "
           f"the host")
    return random_graph(n, src, dst, cfg, g, "cuda"), n, e, pad, how


def phase_gnn_train_cell(arch, shape: str, g) -> None:
    """(a) the shape's train cell through GNNArch.build_cell at the published
    widths (ogb_products cut by GNN_TRAIN_CUTS): GNN_TRAIN_STEPS steps, the
    last under sync debug mode "error", the first (outside the mean)
    profiled for its breakdown; ms a step (mean of steps 2-3), edges/s, the
    model flops (forward and backward, 3 forwards) over 67 TFLOP/s, peak
    memory, the losses finite."""
    import torch

    from repro_torch.models import gnn
    from repro_torch.train import adamw_init
    from repro_torch.train.tree import leaves

    cut = GNN_TRAIN_CUTS.get(shape, 1)
    cell = arch.build_cell(shape)
    cfg = arch.config_for(shape)
    graph, n, e, pad, how = _gnn_graph(shape, cfg, g, cut)
    params = gnn.init(cfg, g, device="cuda")
    state = [params, adamw_init(params)]
    del params
    n_params = sum(t.numel() for t in leaves(state[0]))
    losses, walls = [], []

    def step(graph):
        state[0], state[1], loss = cell.step_fn(state[0], state[1], graph)
        losses.append(loss)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(GNN_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == GNN_TRAIN_STEPS - 1:  # a read-back in the step would raise
            torch.cuda.set_sync_debug_mode("error")
        try:
            if i == 0:
                _train_breakdown(cell.name, lambda: step(graph), GNN_KERNEL_GROUPS)
            else:
                step(graph)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    assert all(x == x and abs(x) < float("inf") for x in losses), \
        f"{cell.name}: loss not finite: {losses}"
    ms = sum(walls[1:]) / len(walls[1:])
    flops = 3 * _gnn_forward_flops(cfg, n, e)
    cut_note = (f"cut 1/{cut} of {cell.meta['n_nodes']} nodes and {cell.meta['n_edges']} "
                f"edges" if cut > 1 else "uncut")
    log(f"gnn {cell.name} {cut_note}: N={n} E={e} padding_edges={pad} ({how}) "
        f"layers={cfg.n_layers} d_hidden={cfg.d_hidden} d_feat={cfg.d_feat} params={n_params} "
        f"steps_ms={'/'.join(f'{w:.1f}' for w in walls)} ms_per_step={ms:.2f} "
        f"edges_per_s={e / ms * 1e3:.4g} model_tflop={flops / 1e12:.3f} "
        f"fp32_share={flops / (ms / 1e3) / FP32_FLOP_PER_S:.4f} (of 67 TFLOP/s) "
        f"peak_gib={_gib(peak):.2f} edges_at_65_gib~{int(e * 65 * 2**30 / peak)} "
        f"losses={'/'.join(f'{x:.6f}' for x in losses)} last_step_sync_debug=error")
    del state, graph
    gc.collect()
    torch.cuda.empty_cache()


def phase_gnn_forward_uncut(arch, g) -> None:
    """(b) ogb_products' forward uncut (2,449,029 nodes, 61,859,140 edges)
    by forward_chunked under no_grad: ms, peak memory, the flop bound,
    the outputs finite."""
    import torch

    from repro_torch.models import gnn

    cfg = arch.config_for("ogb_products")
    graph, n, e, pad, how = _gnn_graph("ogb_products", cfg, g)
    params = gnn.init(cfg, g, device="cuda")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = gnn.forward_chunked(params, graph, cfg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(out).all())
    flops = _gnn_forward_flops(cfg, n, e)
    bound_ms, by = bound(2 * e * cfg.d_hidden * 4 * cfg.n_layers, flops)
    log(f"gnn meshgraphnet/ogb_products forward uncut: N={n} E={e} padding_edges={pad} ({how}) "
        f"chunk={gnn.EDGE_CHUNK} ms={ms:.1f} bound_ms={bound_ms:.1f} ({by}: {flops:.4g} fp32 "
        f"flops; bytes: e read and written a layer) share={bound_ms / ms:.3f} "
        f"inputs_gib={_gib(held):.2f} peak_gib={_gib(peak):.2f} out={tuple(out.shape)} "
        f"finite={finite}")
    assert out.shape == (n, cfg.out_dim) and finite, "gnn ogb_products forward: not finite"
    del graph, params, out
    gc.collect()
    torch.cuda.empty_cache()


def phase_gnn_cpu() -> None:
    """(c) full_graph_sm at full size and width on the card against the CPU
    on the same weights and graph (scripts/gnn_grad_conditioning.py's case):
    the output, the loss and every gradient leaf within GNN_OUT_RTOL,
    GNN_LOSS_RTOL and GNN_GRAD_RTOL of the CPU's largest |value|."""
    from repro_torch.train.tree import tree_map

    study = _gnn_study()
    outputs = study.outputs
    cfg, params, graph, pad = study.case("full_graph_sm", GNN_SEED)
    t0 = time.perf_counter()
    cpu = outputs(params, graph, cfg)
    t1 = time.perf_counter()
    card = outputs(tree_map(lambda t: t.cuda(), params), {k: v.cuda() for k, v in graph.items()},
                   cfg)
    errs = study.rel_errs(card, cpu)
    grads = {k: v for k, v in errs.items() if k.startswith("grad")}
    worst = max(grads, key=grads.get)
    log(f"gnn meshgraphnet/full_graph_sm card vs CPU (seed {GNN_SEED}, padding_edges={pad}, "
        f"CPU {t1 - t0:.1f} s): out {errs['out']:.3g} (limit {GNN_OUT_RTOL:g}) loss "
        f"{errs['loss']:.3g} (limit {GNN_LOSS_RTOL:g}) gradient leaves {len(grads)}, worst "
        f"{worst} {grads[worst]:.3g} (limit {GNN_GRAD_RTOL:g}); median "
        f"{sorted(grads.values())[len(grads) // 2]:.3g}")
    assert errs["out"] <= GNN_OUT_RTOL and errs["loss"] <= GNN_LOSS_RTOL, errs
    assert grads[worst] <= GNN_GRAD_RTOL, grads


def phase_gnn_launcher() -> None:
    """(d) python -m repro_torch.launch.train --arch meshgraphnet on the card
    and on the CPU, each loss within LM_LAUNCHER_RTOL relative; then each
    device's run with a checkpoint every 2 steps, cut at step 2 and resumed
    by the same command: the resumed losses, card against CPU, within the
    same limit (a resumed run draws other edges than an uninterrupted one:
    the launcher's one edge generator, a property of the JAX launcher)."""
    import shutil

    from repro_torch.launch import train

    class _Cut(Exception):
        pass

    class CutAtStep2(train.GraphStream):
        def batch_at(self, step):
            if step == 2:
                raise _Cut()
            return super().batch_at(step)

    def losses(device, resume):
        argv = GNN_LAUNCHER_ARGS + ["--device", device]
        if not resume:
            return [h["loss"] for h in train.main(argv).history]
        d = ROOT / "build" / f"gnn_ckpt_{device}"
        shutil.rmtree(d, ignore_errors=True)
        argv += ["--ckpt-dir", str(d), "--ckpt-every", "2"]
        stream = train.GraphStream
        train.GraphStream = CutAtStep2
        try:
            train.main(argv)
        except _Cut:
            pass
        finally:
            train.GraphStream = stream
        out = [h["loss"] for h in train.main(argv).history]
        shutil.rmtree(d, ignore_errors=True)
        return out

    for resume in (False, True):
        got, want = losses("cuda", resume), losses("cpu", resume)
        errs = [abs(a - b) / abs(b) for a, b in zip(got, want)]
        log(f"gnn train launcher {' '.join(GNN_LAUNCHER_ARGS)}{' resumed at step 2' * resume}: "
            f"card losses {'/'.join(f'{x:.6f}' for x in got)} cpu "
            f"{'/'.join(f'{x:.6f}' for x in want)} worst_rel_err={max(errs):.3g} "
            f"(limit {LM_LAUNCHER_RTOL:g})")
        assert len(got) == len(want) == (1 if resume else 3) and max(errs) <= LM_LAUNCHER_RTOL, \
            (got, want)


def phase_gnn() -> None:
    """Phase 12: MeshGraphNet on the card.  It launches no hand-written
    kernel: every launch count of the phase must stay 0."""
    import torch

    from repro_torch.configs import get_arch

    gc.collect()
    torch.cuda.empty_cache()
    log(f"gnn phase: {_gib(torch.cuda.memory_allocated()):.2f} GiB held by earlier phases")
    arch = get_arch("meshgraphnet")
    g = torch.Generator(device="cuda").manual_seed(GNN_SEED)
    _zero_counts()
    t = [time.perf_counter()]
    for shape in arch.shape_names():
        phase_gnn_train_cell(arch, shape, g)
    t.append(time.perf_counter())
    phase_gnn_forward_uncut(arch, g)
    t.append(time.perf_counter())
    phase_gnn_cpu()
    t.append(time.perf_counter())
    phase_gnn_launcher()
    t.append(time.perf_counter())
    counts = _read_counts()
    log(f"gnn phase: train cells {t[1] - t[0]:.1f} s, uncut forward {t[2] - t[1]:.1f} s, card "
        f"vs CPU {t[3] - t[2]:.1f} s, launcher {t[4] - t[3]:.1f} s; kernel launches "
        f"{sum(counts.values())}")
    assert not any(counts.values()), f"gnn: a hand-written kernel ran: {counts}"


# ----------------------------------------------------------------- phase 13
# The mesh tools (src/repro_torch/launch/mesh.py, train/compress.py, the
# sharded GNN layer, the MoE expert-parallel dispatch, the shard-local
# retrieval, the cells' mesh branches) on the card: one process group of one
# rank (NCCL for the card's tensors, gloo for the host's) and make_host_mesh()
# on "cuda".  A mesh of one rank takes each entry point's local branch, as
# JAX's does, so the collective bodies are also called directly on the
# one-rank group and held to the local path.  The multi-rank behaviour is the
# CPU tests' (tests/test_torch_mesh.py: eight gloo ranks against JAX's
# sharded runs).
MESH_MOE_TOKENS = 2_048   # (b) tokens through one qwen3 MoE layer
# (b) bf16: a token's output row is the sum of its top_k gate-weighted expert
# rows, added by bf16 atomics in no fixed order; two orders differ by the
# roundings of at most top_k - 1 partial sums, each within a bf16 ulp (2**-8)
# of the row's largest |value| here.  fp32 is held to phase 10's block limit.
MESH_MOE_BF16_ULPS = 7
MESH_RETRIEVAL = {"sasrec": 1, "mind": 4}  # (d) arch -> users (retrieval_cand; MIND's 4 interests)
MESH_TRAIN = ("granite-3-2b", 2, 2)        # (e) arch, layers, batch (S 4,096, bf16)
MESH_LM_STEP = 2400  # (e) the AdamW step the train cell starts from: past its 2,000-step warmup
# (e) a new parameter, mu and nu against the cell without a mesh, relative
# to its leaf's largest: the embedding's gradient is an index_add_ of bf16
# atomics (within 2**-8 of its largest), and the clip's norm, which scales
# every leaf's update, reads it
MESH_LM_STEP_RTOL = 2**-7
# (h) the LM serve cells under the (data, model) mesh: cell -> (arch,
# layers, batch, the decode positions)
MESH_LM_SERVE = {"granite-3-2b/prefill_32k": ("granite-3-2b", 2, 1, ()),
                 "granite-3-2b/decode_32k": ("granite-3-2b", 2, 8, (20_000, 32_767)),
                 "gemma3-12b/decode_32k": ("gemma3-12b", 6, 4, (20_000, 32_767))}
# (i) the slice attention and the combine over a cache's slices on one card:
# name -> (B, T, H, KV, hd, slices, positions): granite's decode_32k cache
# over its 16 "model" ranks, gemma's long_500k global cache over the 256
# ranks of 16 x 16; the first position leaves the last slices empty
MESH_SLICES = {"granite_decode_32k": (4, 32_768, 32, 8, 64, 16, (20_000, 32_767)),
               "gemma_long_500k": (1, 524_288, 16, 8, 256, 256, (300_000, 524_287))}
MESH_PATH = ("mips_topk_select", "flash_attn_bf16", "flash_attn_bwd_bf16", "beam_walk",
             "commit_merge", "mips_topk")
MESH_EXAMPLES = ("quickstart_torch", "norm_bias_analysis_torch", "distributed_serving_torch")


def phase_mesh_gnn(mesh, g) -> None:
    """(a) MeshGraphNet at the published widths on full_graph_sm whole:
    forward_blocks / mse_loss_blocks (every layer sharded_layer: all-gather,
    local segment sums, reduce-scatter) on the one-rank group, and the
    gradient mean over it, against the local path."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import axis_group, grad_mean
    from repro_torch.models import gnn as G
    from repro_torch.train.tree import named_leaves, value_and_grad

    group = axis_group(mesh, ("model",))
    cfg = get_arch("meshgraphnet").config_for("full_graph_sm")
    graph, n, e, pad, _ = _gnn_graph("full_graph_sm", cfg, g)
    params = G.init(cfg, g, device="cuda")
    with torch.no_grad():
        out_b = G.forward_blocks(params, graph, cfg, group)
        out_l = G.forward(params, graph, cfg)
    out_err = _rel_err(out_b, out_l)
    loss_b, grads_b = value_and_grad(lambda p, gr, c: G.mse_loss_blocks(p, gr, c, group))(
        params, graph, cfg)
    grads_b = grad_mean(grads_b, mesh, ("model",))
    loss_l, grads_l = value_and_grad(G.mse_loss)(params, graph, cfg)
    errs = {name: _rel_err(got, want) for (name, got), (_, want) in
            zip(named_leaves(grads_b), named_leaves(grads_l))}
    worst = max(errs, key=errs.get)
    loss_err = _rel_err(loss_b, loss_l)
    log(f"mesh (a) gnn full_graph_sm N={n} E={e} (pad {pad}) layers={cfg.n_layers} "
        f"d_hidden={cfg.d_hidden}: sharded layers on the one-rank group against the local "
        f"path: out {out_err:.3e} of its largest (limit {GNN_OUT_RTOL}), loss {loss_err:.3e} "
        f"(limit {GNN_LOSS_RTOL}), worst gradient leaf {worst} {errs[worst]:.3e} (limit "
        f"{GNN_GRAD_RTOL}, index_add_'s atomics reorder the sums)")
    assert out_err <= GNN_OUT_RTOL and loss_err <= GNN_LOSS_RTOL, (out_err, loss_err)
    assert errs[worst] <= GNN_GRAD_RTOL, errs


def phase_mesh_moe(group, g) -> None:
    """(b) one MoE layer at qwen3's widths (d 4,096, 128 experts of d_ff
    1,536, top 8, capacity factor 1.25), MESH_MOE_TOKENS tokens: the
    expert-parallel body on the one-rank group (its rank's experts all 128)
    against the local dispatch, fp32 and bf16."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import moe as M

    cfg = get_arch("qwen3-moe-235b-a22b").cfg
    t, k = MESH_MOE_TOKENS, cfg.moe_top_k
    capacity = max(8, int(t * k / cfg.moe_experts * cfg.capacity_factor))
    for dtype, limit in ((torch.float32, LM_BLOCK_RTOL),
                         (torch.bfloat16, MESH_MOE_BF16_ULPS * 2**-8)):
        p = M.moe_init(g, cfg.d_model, cfg.d_ff, cfg.moe_experts, dtype,
                       expert_split=cfg.moe_expert_split, device="cuda")
        x = torch.randn((t, cfg.d_model), generator=g, device="cuda").to(dtype)
        w = (p["router"], p["w_gate"], p["w_in"], p["w_out"])
        kw = dict(top_k=k, capacity=capacity, split=cfg.moe_expert_split)
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out_p, aux_p = M.expert_parallel(x, *w, 0, group, None, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            out_l, aux_l = M._dispatch_local(x, *w, 0, **kw)
        err = _scaled_err(out_p.float(), out_l.float())
        log(f"mesh (b) moe qwen3 widths {str(dtype).split('.')[-1]} T={t} capacity={capacity}: "
            f"expert_parallel on the one-rank group against the local dispatch: out {err:.3e} "
            f"of a row's largest (limit {limit:.3e}), aux {float(aux_p)!r} vs "
            f"{float(aux_l)!r}; {ms:.1f} ms (wall, one call)")
        assert torch.equal(aux_p, aux_l) and err <= limit, (err, float(aux_p), float(aux_l))
        del p, w, x, out_p, out_l
        torch.cuda.empty_cache()


def phase_mesh_compress(group, g) -> None:
    """(c) the int8 error-feedback all-reduce over one granite layer's
    gradient shapes: the card's means and errors bit-equal to the same
    function on the host's copies (gloo), and its ms beside its byte bound
    (read g and e, write the mean and e', 16 bytes an element)."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.train.compress import compressed_grad_mean
    from repro_torch.train.tree import leaves

    cfg = _lm_cut("granite-3-2b", 1).cfg
    shapes = [tuple(t.shape[2:]) for t in leaves(tf.init(cfg, device="meta")["blocks"])]
    grads = [torch.randn(s, generator=g, device="cuda") for s in shapes]
    errors = [torch.randn(s, generator=g, device="cuda") * 1e-3 for s in shapes]
    mean_c, err_c = compressed_grad_mean(grads, errors, group)
    mean_h, err_h = compressed_grad_mean([x.cpu() for x in grads], [x.cpu() for x in errors],
                                         group)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(mean_c + err_c, mean_h + err_h))
    n = sum(x.numel() for x in grads)
    ms = cuda_ms(lambda: compressed_grad_mean(grads, errors, group), reps=10, warmup=2)
    bound_ms = 16 * n / HBM_BYTES_PER_S * 1e3
    log(f"mesh (c) compressed all-reduce over granite's {len(shapes)} layer tensors "
        f"({n} elements): card == host bit for bit: {same}; {ms:.3f} ms (CUDA events, the "
        f"one-rank all-reduces included) against a byte bound of {bound_ms:.4f} ms "
        f"({ms / bound_ms:.1f}x)")
    assert same


def phase_mesh_retrieval(group, g) -> None:
    """(d) the shard-local retrieval (``sharded_topk``: the rank's top 100
    by mips_topk's select route, gathered over the one-rank group and
    merged) at SASRec's and MIND's retrieval_cand, against the unsharded
    cell's top 100."""
    import torch

    from repro_torch import testing
    from repro_torch.configs import get_arch
    from repro_torch.configs.common import RETRIEVAL_K, sharded_topk

    for aid, users in MESH_RETRIEVAL.items():
        arch = get_arch(aid)
        params = arch.init(g, device="cuda")
        cell = arch.build_cell("retrieval_cand")
        hist = _recsys_inputs(arch, cell.args[1], g, batch=users)
        with torch.no_grad():
            with uncounted():
                want = cell.step_fn(params, hist)
            before = _read_counts()["mips_topk_select"]
            u = arch.user_vectors(params, hist)
            vals, ids = sharded_topk(u, params["item_emb"], 0, group, RETRIEVAL_K,
                                     interests=aid == "mind")
            select = _read_counts()["mips_topk_select"] - before
        ties = testing.assert_topk_match(ids.cpu().numpy(), vals.cpu().numpy(),
                                         want["ids"].cpu().numpy(), want["scores"].cpu().numpy())
        log(f"mesh (d) {aid} retrieval_cand B={users} N={arch.cfg.n_items} "
            f"d={arch.cfg.embed_dim}: sharded_topk ids equal to the unsharded cell's "
            f"(near-tie rows {len(ties)}); mips_topk select launches {select}")
        assert select > 0, "the shard-local retrieval did not take mips_topk's select route"
        del params


def phase_mesh_train(mesh, g) -> None:
    """(e) granite-3-2b's train_4k at the published widths, MESH_TRAIN's
    layers and batch, bf16, on the one-rank (data, model) mesh with JAX's
    layouts (pure FSDP: the parameters held as their specs() shards,
    gathered a layer at a time; the batch over data x model): the gradient
    by mesh_value_and_grad over the specs, and one step through
    build_cell(..., mesh=) from drawn AdamW moments at MESH_LM_STEP, past
    the warmup, against the same cell without a mesh.  A collective over
    one rank is exact: the loss and every gradient leaf are equal but the
    embedding's (its backward is an index_add_ of bf16 atomics, within a
    bf16 ulp of its largest), whose norm the clip reads (MESH_LM_STEP_RTOL
    for the new parameters, mu and nu)."""
    import torch

    from repro_torch.configs.common import mesh_value_and_grad
    from repro_torch.launch.mesh import local_tree, spec_axes
    from repro_torch.models import transformer as tf
    from repro_torch.train.tree import leaves, named_leaves, tree_map, value_and_grad

    aid, layers, b = MESH_TRAIN
    arch = _lm_cut(aid, layers)
    cfg = arch.cfg
    cell_m, cell = arch.build_cell("train_4k", mesh=mesh), arch.build_cell("train_4k")
    pspecs, ospecs, bspecs = cell_m.in_specs
    s = cell.args[2]["tokens"].shape[1]
    params = arch.init(g, device="cuda")
    batch = _train_batch(cfg.vocab, b, s, g)
    blk = local_tree(batch, bspecs, mesh)
    p_m = local_tree(params, pspecs, mesh)
    with uncounted():
        loss_m, grads_m = mesh_value_and_grad(tf.lm_loss, mesh, spec_axes(bspecs["tokens"]),
                                              pspecs)(p_m, blk, cfg)
        loss_l, grads_l = value_and_grad(tf.lm_loss)(params, batch, cfg)
    errs = {name: _rel_err(a, c) for (name, a), (_, c) in
            zip(named_leaves(grads_m), named_leaves(grads_l))}
    unequal = [name for (name, a), (_, c) in zip(named_leaves(grads_m), named_leaves(grads_l))
               if not torch.equal(a, c)]
    del grads_m, grads_l
    opt = _adamw_midway(params, g, MESH_LM_STEP)
    o_m = local_tree(opt, ospecs, mesh)
    p_l = tree_map(torch.clone, params)
    torch.cuda.synchronize()
    before = _read_counts()
    t0 = time.perf_counter()
    _, new_o, step_m = cell_m.step_fn(p_m, o_m, blk)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = {k: v - before[k] for k, v in _read_counts().items()}
    with uncounted():
        _, want_o, step_l = cell.step_fn(p_l, opt, batch)
    step_errs = {part: max(_rel_err(a, c) for a, c in zip(leaves(x), leaves(y)))
                 for part, x, y in (("params", p_m, p_l), ("mu", new_o.mu, want_o.mu),
                                    ("nu", new_o.nu, want_o.nu))}
    same = sum(torch.equal(a, c) for a, c in zip(leaves(p_m), leaves(p_l)))
    # a bf16 norm weight of 1.0 holds still: the step's ~3e-4 is under half its ulp (2**-7)
    moved = all(not torch.equal(a, c) for (name, a), c in zip(named_leaves(p_m), leaves(params))
                if "ln" not in name)
    log(f"mesh (e) {aid} train_4k layers={cfg.n_layers} B={b} S={s} bf16 under the one-rank "
        f"{mesh.mesh_dim_names} mesh, JAX's layouts (batch axes {spec_axes(bspecs['tokens'])}, "
        f"pure FSDP): loss {float(loss_m)!r} vs {float(loss_l)!r} without a mesh; gradient "
        f"leaves not bit-equal {unequal} (worst {max(errs.values()):.3e} of its largest); one "
        f"cell step from step {MESH_LM_STEP} {ms:.1f} ms (wall, first), loss {float(step_m)!r} vs "
        f"{float(step_l)!r}, new params / mu / nu within "
        + " / ".join(f"{e:.3e}" for e in step_errs.values())
        + f" of a leaf's largest ({same} of {len(leaves(p_m))} parameters bit-equal), every "
        f"matrix moved: {moved}; launches flash_attn_bf16 {counts['flash_attn_bf16']} "
        f"flash_attn_bwd_bf16 {counts['flash_attn_bwd_bf16']}")
    assert torch.equal(loss_m, loss_l) and torch.equal(step_m, step_l)
    assert set(unequal) <= {"['embed']"} and max(errs.values()) <= 2**-8, (unequal, errs)
    assert max(step_errs.values()) <= MESH_LM_STEP_RTOL and moved, step_errs
    assert counts["flash_attn_bf16"] > 0 and counts["flash_attn_bwd_bf16"] > 0, counts


def phase_mesh_lm_serve(mesh, g) -> None:
    """(h) MESH_LM_SERVE's cells through build_cell(..., mesh=) on the
    one-rank (data, model) mesh with JAX's layouts (the parameters as their
    specs() shards; Megatron over "model": copy_in, the rank's heads and
    d_ff, sum_out; the embedding's masked gather and the head's vocabulary
    columns; prefill writing its sequence slice of each cache, decode
    writing the new slot's owner and reading its slice by the slice
    attention with the row lse and the combine) against the same cell
    without a mesh on the same inputs: logits and caches bit-equal (one
    slice's combine is exact: its weight e^0 is 1).  The mesh steps'
    launches are the path's."""
    import torch

    from repro_torch.configs.common import LM_SHAPES
    from repro_torch.launch.mesh import local_tree
    from repro_torch.models import transformer as tf
    from repro_torch.train.tree import leaves, tree_map

    for name, (aid, layers, b, positions) in MESH_LM_SERVE.items():
        arch = _lm_cut(aid, layers)
        shape = name.split("/")[1]
        cell_m, cell = arch.build_cell(shape, mesh=mesh), arch.build_cell(shape)
        params = arch.init(g, device="cuda")
        p_m = local_tree(params, cell_m.in_specs[0], mesh)
        s = LM_SHAPES[shape]["seq"]
        runs = []
        if shape == "prefill_32k":
            tokens = torch.randint(0, arch.cfg.vocab, (b, s), generator=g, device="cuda",
                                   dtype=torch.int32)
            args_m = [(p_m, local_tree(tokens, cell_m.in_specs[1], mesh))]
            args_l = [(params, tokens)]
        else:
            caches = tf.init_cache(arch.cfg, b, s, device="cuda")
            for c in leaves(caches):
                c.normal_(generator=g)
            token = torch.randint(0, arch.cfg.vocab, (b, 1), generator=g, device="cuda")
            c_m = local_tree(caches, cell_m.in_specs[1], mesh)
            c_l = tree_map(torch.clone, caches)
            del caches
            args_m = [(p_m, c_m, local_tree(token, cell_m.in_specs[2], mesh), q)
                      for q in positions]
            args_l = [(params, c_l, token, q) for q in positions]
        for a_m, a_l in zip(args_m, args_l):
            torch.cuda.synchronize()
            before = _read_counts()["flash_attn_bf16"]
            t0 = time.perf_counter()
            got = cell_m.step_fn(*a_m)
            torch.cuda.synchronize()
            ms_m = (time.perf_counter() - t0) * 1e3
            launches = _read_counts()["flash_attn_bf16"] - before
            with uncounted():
                t0 = time.perf_counter()
                want = cell.step_fn(*a_l)
                torch.cuda.synchronize()
                ms_l = (time.perf_counter() - t0) * 1e3
            same = [torch.equal(x, y) for x, y in zip(leaves(got), leaves(want))]
            where = "" if shape == "prefill_32k" else f" q_offset={a_m[3]}"
            log(f"mesh (h) {name} layers={layers} B={b}{where} under the one-rank "
                f"{mesh.mesh_dim_names} mesh, JAX's layouts: logits bit-equal {same[0]}, caches "
                f"bit-equal {sum(same[1:])} of {len(same) - 1} (logits within "
                f"{_rel_err(got[0], want[0]):.3e} of the largest); first call {ms_m:.1f} ms "
                f"with the mesh, {ms_l:.1f} ms without (wall); flash_attn_bf16 launches "
                f"{launches}")
            assert all(same), f"(h) {name}: outputs differ from the cell without a mesh"
            assert launches == arch.cfg.n_layers, launches
            runs.append(got)
        del params, p_m, args_m, args_l, runs
        gc.collect()
        torch.cuda.empty_cache()


def phase_mesh_slices(g) -> None:
    """(i) slice_attention over each of MESH_SLICES' cache slices (the
    slice a rank holds, copied out) and combine_slices over them in one
    process, bf16, against the whole-cache flash_attn decode on the same
    inputs (FLASH_TOL's bf16 limit, spread from fp32 scores), at a
    position that leaves the last slices empty (no launch) and at the last
    slot; launches of the sliced path and ms of both logged (the timing
    reps uncounted)."""
    import torch

    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.models.layers import combine_slices, slice_attention

    for name, (b, t, h, kv, hd, n, positions) in MESH_SLICES.items():
        q, k, v = _flash_inputs((b, 1, t, h, kv, hd), torch.bfloat16, g)
        t_loc = t // n
        ks = [k[:, r * t_loc:(r + 1) * t_loc].contiguous() for r in range(n)]
        vs = [v[:, r * t_loc:(r + 1) * t_loc].contiguous() for r in range(n)]

        def sliced(pos):
            parts = [slice_attention(q, ks[r], vs[r], pos - r * t_loc) for r in range(n)]
            return combine_slices(torch.stack([o for o, _ in parts]),
                                  torch.stack([lse for _, lse in parts]))

        for pos in positions:
            before = _read_counts()["flash_attn_bf16"]
            got = sliced(pos)
            torch.cuda.synchronize()
            launches = _read_counts()["flash_attn_bf16"] - before
            with uncounted():
                want = flash_attention(q, k, v, q_offset=pos)
                spread = _flash_spread(q, k, v, pos, None)
                err, _ = _check_flash(f"slices {name} pos={pos}", got, want, spread,
                                      FLASH_TOL["bfloat16"])
                ms = cuda_ms(lambda: sliced(pos), reps=5, warmup=1)
                ms_whole = cuda_ms(lambda: flash_attention(q, k, v, q_offset=pos), reps=5,
                                   warmup=1)
            valid = min(pos // t_loc + 1, n)
            log(f"mesh (i) {name} B={b} T={t} H={h} KV={kv} hd={hd} over {n} slices of {t_loc} "
                f"at pos={pos}: {launches} flash_attn_bf16 launches ({n - valid} slices empty), "
                f"combined in fp32 within bf16 tolerance of the whole-cache decode "
                f"(max_abs_err={err:.3e}); sliced {ms:.3f} ms, whole {ms_whole:.3f} ms (CUDA "
                f"events)")
            assert launches == valid, (launches, valid)
            del got, want, spread
        del q, k, v, ks, vs
        gc.collect()
        torch.cuda.empty_cache()


# (g) the recsys cells under the mesh: rows cut from the published batches
# (train_batch 65,536, serve_bulk 262,144) to keep two steps of each cell
# short; serve_p99 and DLRM's retrieval_cand at theirs
MESH_RECSYS_BATCH = {"train_batch": 8_192, "serve_bulk": 16_384}


# the AdamW step (g)'s train cells start from: past their warmup of 500, so
# the step's learning rate is not 0 and the parameters move
RECSYS_MIDWAY_STEP = 600


def _adamw_midway(params, g, step: int = RECSYS_MIDWAY_STEP):
    """AdamW moments as mid-way through training, drawn from ``g``, at
    ``step``: with nu away from 0 the update is smooth in the gradient
    (from zero moments it is the gradient's sign), and mu and nu after the
    step carry the clipped gradient."""
    import torch

    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.tree import leaves, tree_map

    def draw(p, scale, positive):
        x = torch.randn(p.shape, generator=g, device=p.device, dtype=torch.float32)
        return (x.abs_().add_(1.0) if positive else x).mul_(scale)

    return AdamWState(step=torch.tensor(step, dtype=torch.int32,
                                        device=leaves(params)[0].device),
                      mu=tree_map(lambda p: draw(p, 1e-3, False), params),
                      nu=tree_map(lambda p: draw(p, 1e-4, True), params))


def phase_mesh_recsys(mesh, g) -> None:
    """(g) every recsys train and serve cell, and DLRM's retrieval_cand, at
    the published widths through build_cell(..., mesh=make_host_mesh())
    (tables row-sharded over the one-rank "model" axis: a masked gather and
    an all-reduce a lookup; the batch over the mesh's batch axes, none
    here) against the same cell without a mesh on the same inputs: the
    train step's loss bit-equal and, after one step from drawn moments at
    step RECSYS_MIDWAY_STEP (past the warmup: the parameters move), each
    parameter and each AdamW moment (which carry the clipped gradient)
    within RECSYS_GRAD_RTOL of its leaf's largest (the table gradient is an
    index_add_ of atomics), serve outputs within RECSYS_SCORE_RTOL of their
    largest, retrieval ids equal but at near-ties.  The mesh steps'
    launches are the path's; the comparisons' are not."""
    import torch

    from repro_torch import testing
    from repro_torch.configs import get_arch
    from repro_torch.configs.common import RECSYS_SHAPES
    from repro_torch.launch.mesh import local_tree
    from repro_torch.train.tree import leaves

    for aid in RECSYS_ARCHS:
        arch = get_arch(aid)
        params = arch.init(g, device="cuda")
        for shape in RECSYS_SHAPES:
            if shape == "retrieval_cand" and aid != "dlrm-rm2":  # (d) holds the others
                continue
            cell_m, cell = arch.build_cell(shape, mesh=mesh), arch.build_cell(shape)
            inputs = _recsys_inputs(arch, cell.args[-1], g, batch=MESH_RECSYS_BATCH.get(shape, 0))
            rows = next(iter(leaves(inputs))).shape[0]
            p_m = local_tree(params, cell_m.in_specs[0], mesh)
            b_m = local_tree(inputs, cell_m.in_specs[-1], mesh)
            opt = _adamw_midway(params, g) if shape == "train_batch" else None
            o_m = None if opt is None else local_tree(opt, cell_m.in_specs[1], mesh)
            before = _read_counts()["gather_score"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if shape == "train_batch":
                got = cell_m.step_fn(p_m, o_m, b_m)
            else:
                got = cell_m.step_fn(p_m, b_m)
            torch.cuda.synchronize()
            ms_m = (time.perf_counter() - t0) * 1e3
            gathers = _read_counts()["gather_score"] - before
            del p_m, b_m, o_m
            with uncounted():
                t0 = time.perf_counter()
                if shape == "train_batch":
                    want = cell.step_fn(params, opt, inputs)
                else:
                    want = cell.step_fn(params, inputs)
                torch.cuda.synchronize()
                ms_l = (time.perf_counter() - t0) * 1e3
            if shape == "train_batch":
                errs = {part: max(_rel_err(a, c) for a, c in zip(leaves(x), leaves(y)))
                        for part, x, y in (("params", got[0], want[0]),
                                           ("mu", got[1].mu, want[1].mu),
                                           ("nu", got[1].nu, want[1].nu))}
                moved = all(not torch.equal(a, c) for a, c in zip(leaves(got[0]),
                                                                 leaves(params)))
                check = (f"loss {float(got[2])!r} vs {float(want[2])!r}, after one step from "
                         f"step {RECSYS_MIDWAY_STEP} new params, mu and nu within "
                         + ", ".join(f"{e:.3e}" for e in errs.values())
                         + f" of a leaf's largest; every parameter moved: {moved}")
                assert (torch.equal(got[2], want[2]) and moved
                        and max(errs.values()) <= RECSYS_GRAD_RTOL), check
                del opt
            elif shape == "retrieval_cand":
                ties = testing.assert_topk_match(
                    got["ids"][None].cpu().numpy(), got["scores"][None].cpu().numpy(),
                    want["ids"][None].cpu().numpy(), want["scores"][None].cpu().numpy())
                check = f"top {got['ids'].shape[0]} ids equal (near-tie rows {len(ties)})"
            else:
                err = _rel_err(got, want)
                check = f"outputs {list(got.shape)} within {err:.3e} of the largest"
                assert err <= RECSYS_SCORE_RTOL, check
            log(f"mesh (g) {cell_m.name} rows={rows} under make_host_mesh(): {check}; first "
                f"call {ms_m:.1f} ms with the mesh, {ms_l:.1f} ms without (wall); gather_score "
                f"launches {gathers}")
            if aid in ("sasrec", "mind") and shape != "train_batch":
                assert gathers == 1, f"{cell_m.name}: gather_score launches {gathers}"
            del got, want, inputs
            gc.collect()
            torch.cuda.empty_cache()
        del params


def phase_mesh_examples() -> None:
    """(f) the three examples the port gained, at their defaults (JAX's
    sizes) on the card, their tables printed; quickstart must launch
    beam_walk, commit_merge and mips_topk and no per-step kernel."""
    import importlib

    sys.path.insert(0, str(ROOT / "examples"))
    try:
        for name in MESH_EXAMPLES:
            before = _read_counts()
            t0 = time.perf_counter()
            table = importlib.import_module(name).main([])
            seconds = time.perf_counter() - t0
            counts = {k: v - before[k] for k, v in _read_counts().items()}
            log(f"mesh (f) examples/{name}.py on the card: {seconds:.1f} s; table "
                f"{json.dumps(table, default=float)}; launches "
                f"{ {k: v for k, v in counts.items() if v} }")
            if name == "quickstart_torch":
                _assert_path(name, counts, ("beam_walk", "commit_merge", "mips_topk"))
    finally:
        sys.path.remove(str(ROOT / "examples"))


def phase_mesh() -> dict:
    """Phase 13: the mesh tools on one card.  Returns the launches of its
    paths ((d)'s shard-local retrieval, (e)'s mesh train step, (f)'s
    examples, (g)'s recsys cells, (h)'s LM serve cells, (i)'s slices) for
    the kernels line."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import axis_group, make_host_mesh

    gc.collect()
    torch.cuda.empty_cache()
    store = ROOT / "build" / "mesh_store"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    t = [time.perf_counter()]
    dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.FileStore(str(store), 1), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh()
        group = axis_group(mesh, ("model",))
        mesh2 = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        log(f"mesh phase: world {dist.get_world_size()}, backend {dist.get_backend()}, "
            f"mesh {mesh.mesh_dim_names} {tuple(mesh.shape)} on {mesh.device_type}")
        g = torch.Generator(device="cuda").manual_seed(13)
        _zero_counts()
        t.append(time.perf_counter())
        for fn, args in ((phase_mesh_gnn, (mesh, g)), (phase_mesh_moe, (group, g)),
                         (phase_mesh_compress, (group, g)), (phase_mesh_retrieval, (group, g)),
                         (phase_mesh_train, (mesh2, g)), (phase_mesh_examples, ()),
                         (phase_mesh_recsys, (mesh, g)), (phase_mesh_lm_serve, (mesh2, g)),
                         (phase_mesh_slices, (g,))):
            fn(*args)
            gc.collect()
            torch.cuda.empty_cache()
            t.append(time.perf_counter())
        counts = _read_counts()
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    log("mesh phase: " + ", ".join(f"{name} {b - a:.1f} s" for name, a, b in zip(
        ("init", "(a) gnn", "(b) moe", "(c) compress", "(d) retrieval", "(e) train",
         "(f) examples", "(g) recsys", "(h) lm serve", "(i) slices"), t, t[1:])))
    _assert_path("mesh", counts, MESH_PATH)
    return counts


# ------------------------------------------------------------------ phase 14
# the dry-run (launch/dryrun.py) and its roofline (launch/roofline.py) in a
# process without CUDA: (arch, shape, meshes)
DRYRUN_CELLS = (("sasrec", "serve_p99", "both"), ("granite-3-2b", "train_4k", "single"))
# the memory model's peak against the card's max_memory_allocated on the
# same cell without a mesh
MEMORY_MODEL_RTOL = 0.10
MEASURED_PEAKS = {}  # phase 11 (b): arch -> (layers, batch, bytes its step held at most)


def _card_peak(run, setup) -> int:
    """The most bytes the card held for ``run(*setup())``: its arguments
    (made by ``setup``) and everything the call allocates beside them."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    args = setup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = run(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del args, out
    return peak


DRYRUN_OUT = ROOT / "build" / "dryrun_torch"
DRYRUN_TABLE = ROOT / "build" / "roofline_torch.json"


def start_dryrun() -> subprocess.Popen:
    """DRYRUN_CELLS through ``repro_torch.launch.dryrun`` and the roofline
    over their records, in a subprocess with CUDA_VISIBLE_DEVICES="" that
    must not initialize CUDA.  It uses the host's CPU only, so main starts
    it beside phase 13."""
    import os
    import shutil

    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    DRYRUN_TABLE.unlink(missing_ok=True)
    calls = [f"dryrun.main({['--arch', a, '--shape', s, '--mesh', m, '--out', str(DRYRUN_OUT)]!r})"
             for a, s, m in DRYRUN_CELLS]
    table_args = ["--dryrun-dir", str(DRYRUN_OUT), "--mesh", "both", "--out", str(DRYRUN_TABLE)]
    code = ("import time, torch; t0 = time.perf_counter(); "
            "from repro_torch.launch import dryrun, roofline; "
            + "; ".join(calls) + f"; roofline.main({table_args!r})"
            + "; assert not torch.cuda.is_initialized(), 'CUDA initialized'"
            + "; print(f'dry-run subprocess: {time.perf_counter() - t0:.1f} s after its imports "
              "of torch')")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, "-c", code], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def phase_dryrun(proc: "subprocess.Popen | None" = None) -> None:
    """Phase 14: the dry-run subprocess (``start_dryrun``; started here
    unless ``proc`` is given) and its rows logged.  Then the memory model:
    the dry-run's trace of SASRec's serve_p99 and of phase 11's granite cut
    without a mesh, on meta tensors, against the card's peak for the same
    cells (serve_p99 run here, granite's from phase 11 (b)), within
    MEMORY_MODEL_RTOL."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.train import adamw_init

    proc = proc or start_dryrun()
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        proc.kill()
    for line in stdout.splitlines():
        log(f"dryrun | {line}")
    assert proc.returncode == 0, f"the dry-run failed ({proc.returncode}):\n{stderr[-4000:]}"
    rows = json.loads(DRYRUN_TABLE.read_text())
    records = sorted(DRYRUN_OUT.glob("*.json"))
    assert len(rows) == len(records) == 3 and not any("error" in r for r in rows), rows
    for r in rows:
        log(f"roofline (a model of an H100 SXM, not a measurement) {r['cell']} mesh={r['mesh']} "
            f"n_devices={r['n_devices']} flops={r['flops']:.4e} {r['flops_by_dtype']} "
            f"bytes={r['bytes']:.4e} wire={r['wire_bytes']:.4e} compute_s={r['compute_s']:.4e} "
            f"memory_s={r['memory_s']:.4e} collective_s={r['collective_s']:.4e} "
            f"dominant={r['dominant']} roofline_fraction={r['roofline_fraction']:.4f} "
            f"mem_gib_per_dev={r['mem_gib_per_dev']}")

    g = torch.Generator(device="cuda").manual_seed(14)
    arch = get_arch("sasrec")
    cell, meta_cell = arch.build_cell("serve_p99"), arch.build_cell("serve_p99", device="meta")
    with uncounted():
        card = _card_peak(cell.step_fn, lambda: (arch.init(g, device="cuda"),
                                                 _recsys_inputs(arch, cell.args[1], g)))
        model = trace_step(meta_cell.step_fn, meta_cell.args)["memory"]["peak_bytes_per_device"]
    checks = [("sasrec/serve_p99", model, card)]
    layers, batch, card = MEASURED_PEAKS["granite-3-2b"]
    meta_cell = _lm_cut("granite-3-2b", layers).build_cell("train_4k", device="meta")
    params = meta_cell.args[0]
    tokens = torch.empty((batch, meta_cell.args[2]["tokens"].shape[1]), dtype=torch.int32,
                         device="meta")
    with uncounted():
        model = trace_step(meta_cell.step_fn, (params, adamw_init(params),
                                               {"tokens": tokens, "labels": tokens.clone()})
                           )["memory"]["peak_bytes_per_device"]
    checks.append((f"granite-3-2b/train_4k layers={layers} B={batch}", model, card))
    for name, model, card in checks:
        rel = abs(model - card) / card
        log(f"memory model {name}: dry-run peak {model} B ({_gib(model):.3f} GiB) vs the card's "
            f"max_memory_allocated {card} B ({_gib(card):.3f} GiB): {rel:.4f} apart "
            f"(limit {MEMORY_MODEL_RTOL})")
        assert rel <= MEMORY_MODEL_RTOL, (name, model, card)


# kernel -> (its source, the TPU kernel it replaces)
SOURCES = {
    "beam_step": ("src/repro_torch/csrc/beam_step.cu",
                  "src/repro/kernels/beam_step/kernel.py:50"),
    "beam_step_int8": ("src/repro_torch/csrc/beam_step.cu",
                       "src/repro/kernels/beam_step/kernel.py:151"),
    "beam_step_live": ("src/repro_torch/csrc/beam_step.cu",
                       "src/repro/kernels/beam_step/kernel.py:178"),
    "beam_step_int8_live": ("src/repro_torch/csrc/beam_step.cu",
                            "src/repro/kernels/beam_step/kernel.py:178"),
    "beam_walk": ("src/repro_torch/csrc/beam_step.cu",
                  "src/repro/kernels/beam_step/kernel.py:50"),
    "beam_walk_int8": ("src/repro_torch/csrc/beam_step.cu",
                       "src/repro/kernels/beam_step/kernel.py:151"),
    "beam_walk_live": ("src/repro_torch/csrc/beam_step.cu",
                       "src/repro/kernels/beam_step/kernel.py:178"),
    "beam_walk_int8_live": ("src/repro_torch/csrc/beam_step.cu",
                            "src/repro/kernels/beam_step/kernel.py:178"),
    "commit_merge": ("src/repro_torch/csrc/commit_merge.cu",
                     "src/repro/kernels/commit_merge/kernel.py:78"),
    "mips_topk": ("src/repro_torch/csrc/mips_topk.cu",
                  "src/repro/kernels/mips_topk/kernel.py:48"),
    "mips_topk_int8": ("src/repro_torch/csrc/mips_topk.cu",
                       "src/repro/kernels/mips_topk/kernel.py:69"),
    "mips_topk_select": ("src/repro_torch/csrc/mips_topk.cu",
                         "src/repro/kernels/mips_topk/kernel.py:48"),
    "mips_topk_select_int8": ("src/repro_torch/csrc/mips_topk.cu",
                              "src/repro/kernels/mips_topk/kernel.py:69"),
    "quant_score": ("src/repro_torch/csrc/quant_score.cu",
                    "src/repro/kernels/quant_score/kernel.py:23"),
    "gather_score": ("src/repro_torch/csrc/gather_score.cu",
                     "src/repro/kernels/gather_score/kernel.py:34"),
    "topk_merge": ("src/repro_torch/csrc/topk_merge.cu",
                   "src/repro/kernels/topk_merge/kernel.py:55"),
    "flash_attn": ("src/repro_torch/csrc/flash_attn.cu",
                   "src/repro/kernels/flash_attn/kernel.py:34"),
    "flash_attn_bf16": ("src/repro_torch/csrc/flash_attn.cu",
                        "src/repro/kernels/flash_attn/kernel.py:34"),
    # no Pallas kernel: the JAX package's attention backward, a custom VJP
    "flash_attn_bwd": ("src/repro_torch/csrc/flash_attn_bwd.cu",
                       "src/repro/models/layers.py:235"),
    "flash_attn_bwd_bf16": ("src/repro_torch/csrc/flash_attn_bwd.cu",
                            "src/repro/models/layers.py:235"),
}


def timed(name: str, fn, *args):
    """``fn(*args)``, its seconds logged under the phase's ``name``."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs the card",
              file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401 -- fails here when run without the repository

    t0 = time.perf_counter()
    count_graph_launches()
    card = timed("1 environment", phase_env)
    timed("2 build", phase_build)
    timings, entry_counts = timed("3 kernels", phase_kernels)
    k33_counts = timed("4 serve default", phase_serve_default)
    timed("4b churn default", phase_churn_default)
    timed("4c serve loop default", phase_serve_loop_default)
    counts = timed("5 full size", phase_full_size)
    loop_runs = timed("5b loop full size", phase_loop_full)
    timed("5d observability", phase_observability, loop_runs)
    # each kernel's launches on the full-size path that runs it
    counts.update({name: n for name, n in timed("6 churn full size", phase_churn_full).items()
                   if name.endswith("_live")})
    counts.update(entry_counts)
    counts.update({name: k33_counts[name] for name in K33_PATH})
    # the sharded path's launches come on top, and the index family's, the
    # recsys cells', the LM family's and LM training's
    for name, fn in (("7 sharded", phase_sharded), ("8 index family", phase_index_family),
                     ("9 recsys", phase_recsys), ("10 LM", phase_lm)):
        for kernel, n in timed(name, fn).items():
            counts[kernel] += n
    train_counts, train_timings = timed("11 LM training", phase_lm_train)
    for name, n in train_counts.items():
        counts[name] += n
    timings.update(train_timings)
    timed("12 GNN", phase_gnn)
    dryrun = start_dryrun()  # phase 14's CPU-only subprocess, beside phase 13
    for name, n in timed("13 mesh", phase_mesh).items():
        counts[name] += n
    timed("14 dry-run", phase_dryrun, dryrun)
    log(f"all phases: {time.perf_counter() - t0:.1f} s")
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=counts[name], **timings[name])
               for name, (src, rep) in SOURCES.items()]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
