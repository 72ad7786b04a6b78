"""Drive the PyTorch port's serving and training paths on one NVIDIA H100.

    python3 chip_smoke.py            # one card, no arguments
    python3 chip_smoke.py --train-depth llama 8 12 16 18 20
                                     # the train_decoder depths' peak
                                     # memory (``train_depth``)
    python3 chip_smoke.py --only recsys
                                     # device, build and the recsys
                                     # phase alone (``only_phases``;
                                     # also dimenet, dryrun, sharded,
                                     # sharded_engine, sharded_dimenet,
                                     # sharded_recsys, or several)

Phases, run in this order, each printing one JSON line:

1. device  — ``nvidia-smi`` name and power limit, compute capability
             (9, 0) required.
2. build   — compile the CUDA kernels from ``src/repro_torch/csrc``.
3. kernels — each kernel against its plain PyTorch version on the card
             (K4 and K5 through both entries, on windows and reading an
             index in place, bit for bit, across two launches and against
             each other; K2 and K3 also against the dense oracle, and bit
             for bit against a second launch, also on sparse, skewed,
             one-position and empty-bucket routings), K6 also past its
             old k limit of 256, and past the old limits of the head: K2
             at S = 1729 and 2048 (and launched for a longer sequence
             than i_max reaches: the same bits, zeros past it), K1, K2
             and K3 at B = 65536. Each K1 case runs twice (the same bits) on
             the path its rule gives ("tma", "wmma" or "f32"), also at
             full width (D 768, V 30522: S 48, 900, 1729), on masks that
             empty whole 128-position chunks and on exact ties, where
             i_max must equal the plain version's everywhere. K4 and K5
             also on queries whose ids lie outside [0, V), read by the
             reference's gather rule (a negative id plus V, then clamped
             to [0, V - 1]) in the kernels and their plain versions. K4's
             ceiling entry (tier 1 of the pruned path) bit for bit against
             its plain version and across two launches at k 65, 129 and
             257 (past the slice kernel's k <= 32 warp threshold), with
             lists filled by zero-ceiling docs, k past n_docs, many
             slices, a 130-term query and ids outside [0, V).
4. serve   — the full-width splade_bert serving path: index 16384 docs,
             serve 64 requests through the batching loop, retrieve with
             ``method="auto"`` (which must resolve to the fused kernel, K4
             reading the index in place); two ``impact`` retrievals give
             the same bits.
   serve_dense — the same path with dense reps (``--rep-topk 0``): a
             (16384, 30522) f32 corpus, ``auto`` resolving to the
             streaming kernel (K6), held against the ``dense`` method and,
             on the sparse phase's reps, against K4; then K6 at k = 257
             and 300, and on a bf16 and a non-contiguous corpus, against
             the ``dense`` method.
   serve_engine — the online index engine: 20480 docs grown through a
             ``CorpusEngine(quantize=True)`` one batch of 64 at a time, 5 %
             tombstoned (searched once zeroed in place), then compacted
             away, one more batch as the delta; the served queries
             searched with ``auto`` (the quantized base resolving to K5)
             and ``fused`` (K5 on the base, K4 on the delta, both reading
             their segment in place), held against
             the ``quantized`` method; the JAX package's acceptance
             corpus quantized on the card, at least 4x smaller; then K4
             and K5 at k = 1025, 1100 and n_docs on the base, against the
             ``impact`` and ``quantized`` methods; two ``quantized``
             searches give the same bits; each search method's host ms.
   serve_pruned — two-tier pruned retrieval: 20480 docs grown through a
             ``CorpusEngine(keep_forward=True)`` one batch of 64 at a time,
             5 % tombstoned (searched once zeroed in place: postings and
             forward rows), then compacted away, one more batch as the
             delta; each time the 64 served requests searched with
             ``auto`` (resolving to ``pruned``: K4's ceiling entry once a
             pruned segment, the delta's too), twice (the same bits),
             ``impact``, ``fused``, ``pruned`` with every doc a candidate
             and at margins 0.5 and 1.0, held to ``impact`` (all ids, or
             the top-1 at a margin, equal beyond near-ties; ``auto`` on
             the rows whose segments' ``exact_frontier`` holds, each
             returned score its doc's exact score elsewhere); the base's
             ``exact_frontier`` true on every row at margin 0; then the
             ceiling entry timed at the search's budget C + 1 (B 8 and
             64) and k 257 beside K4 in place, and the searches' host ms.
   serve_frontier — the serving frontier (``runtime/frontier``) at full
             width: the serve CLI's ``run`` on serve_pruned's engine as it
             stands, its loop continuous with a 5 s deadline and an
             admission bound (every request served), the 8 retrieved
             queries searched through a ``CachedEngine`` (64 MB, a quarter
             of it pinned hot windows) with ``fused`` twice: pass 1 all
             misses through K4's window entry on the hot windows, pass 2
             all hits and no launch, both bit for bit cache-off ``fused``
             (K4 in place); then 64 docs added and 16 of the returned
             removed: the generation moves, the entries are invalidated,
             the cached search equals cache-off with no removed id; and
             ``auto`` (the hot scorer declines) equals cache-off ``auto``.
             Then the CLI's ``run_tenants``: 3 tenants (weights 1, 2, 3,
             4096 docs each) over the encoder wrapped by ``inject_faults``
             (a persistent poison in t1's requests, a one-shot OOM on
             t2's last): every uid completes once, the poison fails only
             in t1, the OOM halves t2's cap, each tenant's cached search
             equals its engine's; a contended window's dispatches by
             tenant. Then the host ms of a cached hit, a cache-off
             ``fused`` and a hot-window miss search, and K4's window entry
             on the hot windows beside K4 in place (CUDA-graph replays),
             each with its byte bound.
5. timing  — each kernel, its plain version, a one-call PyTorch yardstick
             and its roofline bound, with CUDA events (K4 and K5, whose
             calls take less device time than their enqueue, from CUDA
             graph replays, at the served 8 queries and all 64, both
             entries, with digests of their results; K1's bound counts
             the products of its kept positions only; K1 also at the
             train step's 384 x 256 and Table-1, each beside its earlier
             WMMA design forced on the same inputs, ``ms_wmma``; K6 at B 8
             and B 64; K2 and K3 on four rows, ``BWD_ROWS``: the train
             step's 384 x 256, Table-1, and "sparse" and "skewed"
             routings at 384 x 256 beside ``torch.sparse.mm``); for K2
             and K3 also the peak memory of the head's forward + backward
             against the paper's PyTorch baseline, for K6 the peak memory
             of kernel and yardstick. The dense corpus and the engine are then dropped.
6. train   — the full-width splade_bert train step: one step's gradients
             with the kernel head against the plain head (32 x 128), split
             into the backward's and the forward's share, then 5 timed
             steps of the train CLI's own loop (``launch.train.make_runner``:
             its ``FaultTolerantRunner`` and loader) at the paper's Table-3
             point (384 pairs x 256 tokens, remat on) with the head it
             picks by default, K1, K2 and K3 launched twice a step, no
             step raising or skipped.
7. eval    — the quality loop (``repro_torch.eval``): (a) the method
             matrix on ``benchmarks/bench_quality.py``'s graded corpus (512
             docs, 16 queries): ``exact`` must read nDCG@10 = MRR@10 = 1.0,
             and ``pruned`` (K4's ceiling entry), ``quantized``, ``fused``
             (K4 in place) and ``quantized_fused`` (K5 in place) sit
             within 1e-3 of it on every metric; ``aggressive`` (pruned at
             margin 0.5) is printed beside them; (b) the train CLI driven through its own
             ``run`` at full width, ``--full --steps 10 --batch 32
             --seq-len 32 --eval-every 10 --eval-queries 16384``: two
             evaluations, each encoding 32768 rows through K1 and searching
             a 16384-doc index with ``exact`` (``auto`` resolving to K4 in
             place), with their wall seconds split into encode, index build
             and search; the final reps also searched with ``impact`` (ids
             equal to exact's but at near-ties) and ``quantized`` (K5);
             (c) the bench's trained-vs-init recipe on SMOKE splade_bert,
             from one init with the kernel head and with the paper's
             PyTorch baseline head (``naive``): at step 1000 each must beat
             its init by 0.01 on MRR@10 and nDCG@10 with a falling loss;
             the gap between the heads is printed. Its 1000 small steps a
             head are bound by the host, so each head runs in a spawned
             process of its own from the phase's start, beside (a), (b)
             and the other head.
8. xlmr    — splade_xlmr (|V| 250002) at full width: the serve phase's
             path (16384 docs, 64 requests, ``auto`` resolving to K4 in
             place); then on its weights and queries the serve_engine,
             serve_pruned and serve_dense phases' paths, one after the
             other with each one's index dropped (xlmr_serve_engine: K5
             in place on a 19456-doc quantized base; xlmr_serve_pruned: K4's
             ceiling entry on the base and the delta, the base's
             ``exact_frontier`` share printed, not required to be 1: the
             reference's pruning misses a doc on rows where it fails;
             xlmr_serve_dense: K6
             on a (16384, 250002) f32 corpus of 16.4 GB, then K6 against K4
             on the sparse index as a second such corpus), their gates but
             those that do not depend on V (the acceptance corpus, K4, K5
             and K6 past their old limits); K5 in place and K6 at B 8 timed
             there (xlmr_serve_timing); K1 (with its 146-column last tile),
             K2 and K3 (every routing list in device memory) at its V
             against their plain versions; the gradient check at 8 x 128;
             3 timed steps of the train CLI's loop at train_420 (420 pairs x
             256 tokens, remat on) and 3 at train_16 with the kernel head
             and 3 with the paper's PyTorch baseline head (``naive``), each
             with its peak memory; then K1, K2 and K3 timed at train_420
             (K2 and K3 on the random-init routing and on each row's 256
             largest y).
   sharded_engine — the doc-, term- and 2D-sharded index engines, run
             inside xlmr (its own line in the timeline) on the 19456 live
             rows of xlmr_serve_engine's engine and the 8 and 64 served
             queries: (a) one process, ``retrieve`` with ``sharded`` at 2
             and 4 shards, ``term_sharded`` at 2 and 4 (mass cuts) and
             ``shard2d`` at 2 x 2, exact and (term, 2D) pruned at margin
             0.5 with 256 candidates, against the unsharded index of the
             same rows: doc-sharded the same bits as ``impact``, term and
             2D ids equal to ``impact``'s but at near ties (term pruned
             likewise to the unsharded ``pruned``; 2D pruned, whose cell
             ceilings are tighter, its scores exact and its top-1
             ``impact``'s); (b) one gloo world of 4 ranks sharing the
             card on a (2, 2) mesh: ``sharded`` and ``term_sharded`` on
             each axis, ``shard2d`` in both axis orders, exact and
             pruned: each rank the one-process result bit for bit, every
             rank the same, both orientations the same bits; (c)
             ``CorpusEngine(shard_axis="term", n_shards=2)`` and one with
             a 2 x 2 ``plan`` (forward rows kept), 4096 docs grown by
             ``launch.serve.grow_engine`` (5 % tombstoned), compacted, a
             delta of 64: ``auto``, ``fused`` and ``pruned`` ids equal to
             a shard-free engine's ``impact`` but at near ties, ``fused``
             K4 once (the delta), ``auto`` K4's ceiling entry once; (d)
             the serve CLI's ``run`` with ``--method sharded``,
             ``term_sharded`` (2 shards) and ``shard2d`` (4, 2d) on
             splade_bert's seed-0 weights: every request served. Host ms
             of every search (median of 10), gloo's time by collective,
             each index's ``memory_bytes``. ``python3 chip_smoke.py
             --only sharded_engine`` runs device, build, the xlmr serve
             and engine phases and this one.
   sharded_dimenet — DimeNet's row-sharded path (``sparse/distributed``;
             ``build_gnn_train_step(shard_axes=, mesh=)``) at its CONFIG
             (d 128, 6 blocks, K 8, f32, TF32 off), run in
             sharded_engine's gloo world after its cases (its own line in
             the timeline): (a) full_graph_sm relabelled for the 2
             ``model`` shards (``sd_balanced``: no request dropped) and
             molecule's flat triplets over both axes, the sharded loss
             and gradients against the one-process step within
             DIMENET_TOL of each leaf (or its f64 control), every dropped
             count 0; (b) full_graph_sm in the reference's layout over
             both axes: each take's and sum's dropped count and the
             difference from the one-process step printed; (c) 2 steps a
             case, every rank the same state bits after each, the first
             step taken twice the same bits; host ms a step a rank,
             gloo's ms by collective; ogb_products printed as skipped.
             ``python3 chip_smoke.py --only sharded_dimenet`` runs
             device, build and this phase in a world of its own.
   sharded_recsys — the recsys steps over a mesh
             (``sparse/sharded_embedding``; ``build_recsys_train_step(
             mesh=, param_specs=, zero_specs=)``, ``build_recsys_serve_step
             (cfg, mesh, param_specs)``, ``build_retrieval_step(cfg,
             mesh)``) at DLRM's CONFIG (embed 128, 26 tables capped at
             DLRM_ROW_CAP, f32, TF32 off) on sharded_engine's (2, 2)
             world after sharded_dimenet (its own line in the timeline):
             the one-process references taken on the card before the
             world spawns (the step at train_batch 65536, the serve step
             at serve_p99, the retrieval step and K6, the check, at
             retrieval_cand B 1, 8 and 64); each rank's state built by
             ``new_state(mesh=, specs=)`` (its bytes the specs' count,
             3.877 GB), the serve probabilities within SR_PROB_TOL, the
             retrieval ids equal to the one-process step's and K6's but
             at near ties, one train step (gloo's ms and bytes by
             collective) whose loss is within SR_LOSS_RTOL and whose
             probe rows and MLP leaves are within SR_UPDATE_TOL of the
             one process's, every block the same bits on its holders,
             a second step timed; the published DLRM's bytes a rank
             (meta count) at (2, 2) and (2, 4). ``python3 chip_smoke.py
             --only sharded_recsys`` runs device, build and this part in
             a world of its own.
9. ckpt    — checkpoint and resume, splade_xlmr at full width through the
             train CLI's own ``run`` at train_16 (16 pairs x 256): (a) 4
             steps with ``--ckpt-every 2`` (checkpoints at steps 2 and 4,
             3.67 GB of state each), K1, K2 and K3 twice a step call (a
             step the runner retries past its deadline is called twice); (b) the
             checkpoint loaded back onto the card, bit for bit the state
             of step 4; (c) ``--resume --steps 6``; (d) its state against
             the same 2 steps run on from step 4 in memory through the
             CLI's loop (a runner checkpointing only at its end): bit for bit,
             or, if the trunk is not run-to-run reproducible, within a
             second in-memory run's own difference; (e) no step skipped;
             (f) the device-to-host copy, write and load seconds, the
             bytes on disk, the free disk before, and the step ms with and
             without a write in flight; (g) the example
             ``repro_torch.examples.train_splade``: 200 SMOKE steps, the
             loss falling, its in-batch acc@1.

10. example_serve — ``repro_torch.examples.serve_retrieval`` (SMOKE
             splade_bert, 512 docs, 24 queries, top 5) once for each of its
             flag sets (none; --engine --quantize; --engine --prune-margin
             0.0; --engine --cache-mb 4), every plain version guarded: its
             own checks, K1 on every encode, K6 in its part 3b, K4's
             ceiling entry under --prune-margin; the wall s, launches,
             self-retrieval rate, served/shed/failed, cache stats and
             whether every id check held without the near-tie rule.
    example_quickstart — ``repro_torch.examples.quickstart`` (B 4, S 64,
             D 128, V 30522, f32: K1's "f32" path), then
             ``sparton_forward_with_indices`` against K1 and K1 against
             its plain version on its inputs.
    streaming — ``launch.steps.streaming_topk`` (tile 65536) against K6
             (through ``retrieve``, ``auto`` -> streaming) at the JAX
             package's retrieval_cand shape, C (1000448, 128) f32, k 100,
             B 1, 8 and 64 (K6's FMA and 3xTF32 paths): values within
             K6_TOL, ids equal but at near ties; K6 timed with its plain
             version, ``torch.topk(q @ C.T)`` and its bound, beside
             ``streaming_topk``'s ms, with the peak MB of all three, and
             a torch.profiler trace of ``streaming_topk``.

11. decoder — the dense decoders' serving paths at full width, bf16,
             seeded random weights, the kernel head: llama3.2-3b (28
             layers, D 3072, V 128256) through the serve phase's path
             (16384 docs, 64 requests, ``auto`` -> K4 in place), the LSR
             prefill (``launch.steps.build_lsr_prefill_step``) at B 1 x
             16384 with K1 held against its plain version on the trunk's
             H (K1 alone is timed at 1 and 2 x 32768), KV-cache decode (B 4, 64 positions) against
             ``causal_lm_logits`` at f32 compute (DECODE_TOL; the bf16
             difference printed) and one decode step timed at the
             decode_32k cache (B 4 x 32768, 15.0 GB); then gemma2-27b at
             full width and 4 layers (D 4608, V 256000, window 4096 on
             the even layers, softcaps 50 and 30): the prefill at B 2 x
             8192 (K1 with softcap 30.0 against its plain version) and
             decode from position 0 to 4159 against ``causal_lm_logits``
             at 4096-4159, where the window cuts (f32 only). Then K1 timed at the
             serve batch (64 x 16), llama's (1, 32768) and (2, 32768) and
             gemma2's (2, 8192), each beside its bound, its plain version,
             the one-call yardstick and the paper's baseline head
             (``naive``, where three f32 copies of its logits fit), with
             peak memory.

12. moe     — the MoE decoders' serving paths at full width, bf16, seeded
             random weights, the kernel head: moonshot-v1-16b-a3b at full
             width, 24 of its 48 layers (D 2048, 64 experts top-6, V
             163840 tied: 27.7 GB of weights) through the serve phase's
             path (16384 docs, 64 requests, ``auto`` -> K4 in place; K4
             then timed on its index at B 8 and 64; three encode batches
             traced with torch.profiler), the LSR prefill at B 2
             x 8192 (16384 routed tokens) with K1 held against its plain
             version on the trunk's H and a second prefill giving the same
             bits, KV-cache decode (B 4, 64 positions) against
             ``causal_lm_logits`` at f32 on views of its first 4 layers at
             a capacity that drops nothing (``capacity_factor`` =
             n_experts, DECODE_TOL; at the config's 1.25 printed), one
             decode step timed (and traced) at a B 4 x 4096 cache beside
             its byte bound (the cache and every expert's weights) and one
             layer's ``moe_ffn`` alone at T 16384 beside its operations
             bound;
             then phi3.5-moe at full width and 8 of its 32 layers (D 4096,
             16 experts top-2, GQA 32/8, V 32064 untied): the same prefill,
             decode comparison and ``moe_ffn`` timing. Then K1 timed at
             moonshot's 64 x 16 and 2 x 8192 and phi3.5-moe's 2 x 8192, as
             in the decoder phase.

13. train_decoder — the dense and MoE decoders' training at full width,
             bf16 params and compute, seeded random weights, the kernel
             head: (a) K2 and K3 at B 2 x S 4096 (train_4k's length) at
             the five decoders' (D, V, softcap): llama3.2-3b (3072,
             128256), phi3-mini (3072, 32064), gemma2-27b (4608, 256000,
             30), moonshot (2048, 163840) and phi3.5-moe (4096, 32064),
             against their plain versions and a second launch on
             ``bwd_inputs``, then timed beside their bound, their plain
             versions and the baseline head's backward; (b) the gradient
             check (the train phase's, with its in-run controls) on
             llama and moonshot at 2 layers, 4 pairs x 512; (c) one
             warm-up and 2 timed steps of ``build_lsr_train_step`` on the
             train CLI's ``pair_loader`` at S 4096 (remat on): llama at
             ``LLAMA_TRAIN_LAYERS`` of 28 layers (4 pairs, n_micro 2),
             gemma2 at 2 of 46 (2 pairs), moonshot at 3 of 48 (4 pairs,
             n_micro 2, the objective's aux term), each step's ms, peak
             memory, loss and K1/K2/K3 launches (2 x n_micro each) with
             their CUDA-event ms; K1, K2 and K3 against their plain
             versions on each warm-up step's own routing; moonshot's
             first gradients taken twice (whether the MoE backward gives
             the same bits run to run, printed); (d) the CLI's loop
             (``make_runner``) on llama at 2 layers writing its final
             checkpoint with bf16 params, loaded back bit for bit.

14. recsys  — the recsys family at published width, f32 (TF32 off),
             seeded random weights, one family at a time: DLRM (its 26
             tables capped at ``DLRM_ROW_CAP`` = 2^21 rows, 7.04 GB of
             96.2 GB: the one cut of scale), xDeepFM, DIEN and
             Wide&Deep. (a) One probe step of ``build_recsys_train_step``
             at train_batch 65536, halved until it fits (xDeepFM's CIN),
             then 3 steps of the train CLI's loop (``make_runner`` over
             ``recsys_loader``, Adagrad at 1e-2) with its final checkpoint
             (14.1 GB for DLRM) in a ``tempfile`` directory: losses finite
             and not rising, the runner's step ms, peak memory; (b)
             ``build_recsys_serve_step`` at serve_p99 (512) and serve_bulk
             (262144, halved until it fits): probabilities in [0, 1], CUDA
             ms; (c) ``build_retrieval_step`` at retrieval_cand (B 1,
             1000448 x embed_dim candidates, k 100), its ids held against
             K6 and ``topk_rows(q @ C.T)`` on the same query vector (equal
             but at near ties), and K6 timed there beside its byte bound
             (D 128, 10, 18, 32). No kernel is on these paths: K1-K6 must
             launch no time in (a), (b) or the step of (c).
             ``python3 chip_smoke.py --only recsys`` runs the device and
             build phases and this one alone.

15. dimenet — DimeNet's full CONFIG (6 blocks, d 128, bilinear 8,
             spherical 7, radial 6), f32 (TF32 off), seeded random
             weights, through ``launch/steps.build_gnn_train_step`` at
             three SHAPES_GNN shapes, ``d_feat`` as the JAX cells set it:
             (a) molecule (128 graphs x 30 atoms, E 8192, ``d_feat`` 0):
             exact flat triplets padded to a multiple of 512, the graph
             MSE, 10 steps on one batch at lr 2e-3 (the loss must fall);
             (b) full_graph_sm (2708 nodes, 10556 edges, ``d_feat`` 1433,
             padded to N 3072, E 10752): capped triplets (K 8) in the
             dense (E, 8) layout, the node-mask MSE, 5 steps, and
             ``forward`` on the flat triplets equal to the dense within
             DIMENET_TOL; (c) minibatch_lg: a 232,965-node host graph of
             up to 114,615,892 edges (cut, and the cut printed, if a 1/16
             probe predicts more than 60 s), 1024 seeds fanned out (15,
             10), padded to N 169984, E 168960, ``d_feat`` 602, dense
             (168960, 8) triplets, the seed MSE, 5 steps. At each shape:
             the host build seconds, the real triplets, each step's
             CUDA-event ms and the peak, losses finite, two runs of one
             step's gradients the same bits (``sparse/segment``'s sorted
             sums, no atomics), K1-K6 launched no time; at (a) and (b) one
             step's loss and gradients within DIMENET_TOL of the port's
             CPU step (or of its f64 control), the f64 steps of both
             devices within DIMENET_F64_TOL. ogb_products is printed as
             skipped (253 GB of gathered messages a block: multi-GPU,
             item 10).
             minibatch_lg's host batch (its graph most of a minute of
             numpy) is built in a spawned process from the build phase on,
             while the earlier phases run. ``python3 chip_smoke.py --only
             dimenet`` runs the device and build phases and this one alone
             (building it inline).

16. dryrun — the dry run (``launch/dryrun.py``): (a) ``dryrun.main``
             over the default 40 cells and the two SPLADE encoders' 5,
             one ``--arch`` at a time in ``DRYRUN_WORKERS`` spawned
             processes from the xlmr phase on, the card hidden from
             them (the abstract pass runs on meta tensors): a line a
             cell (kind, FLOPs by dtype, bytes, peak estimate, fits,
             roofline seconds and bottleneck, model FLOPs, useful ratio),
             every cell ``ok`` but the 4 skipped; (b) one step of each of
             the seven step kinds on the card (``DRYRUN_MEASURED``, cut
             where the published cell does not fit one card, each cut
             estimated at its cut): the step's first call a warm-up,
             then ``max_memory_allocated`` of the second above what was
             allocated before its state, held within 10 % or 256 MiB of
             the same cell's peak estimate; the step's CUDA-event ms and
             its ratio to the roofline seconds printed; K1-K3 launched in
             the LSR steps (K1 on "tma"), no plain version on the card,
             the outputs finite. ``python3 chip_smoke.py --only dryrun``
             runs the device and build phases and this one alone.

17. sharded — the vocab-sharded head and LSR training on two gloo ranks
             sharing the card (``launch.mesh.spawn_world``; a
             ``FileStore`` in a ``tempfile`` directory), splade_xlmr's
             CONFIG at full width, bf16, seeded weights the same on both
             ranks; the parent computes the references with the port's
             unsharded steps on the same card: (a) mesh (data 1, model
             2): ``build_lsr_prefill_step`` at 64 x 16, the two Y blocks
             gathered within K1_TOL of the unsharded prefill's (whether
             the bits are equal printed), K1 once a rank on "tma" at
             V_local 125001; then one train_16 step of
             ``build_lsr_train_step`` (remat on), every rank holding the
             whole state; (b) mesh (data 2, model 1): the same step, the
             batch split over ``data``;
             gates at each: the loss within SHARDED_LOSS_RTOL of the
             unsharded step's, the first moments per leaf within
             GRAD_RATIO x the larger of the xlmr gradient check's bf16
             controls and a control at this shape (the unsharded step with
             the vocabulary permuted: every f32 sum over V in another
             order, as the model mesh orders them), the parameters and
             the moments the same bits on both ranks, K1-K3 2 x n_micro
             on "tma", no plain version on the card; (c)
             ``compressed_allreduce`` over ``data`` on each rank's
             gradient share, twice (the residual carried), within the
             int8 bound; (d) on each mesh one warm-up and SHARDED_STEPS
             timed steps of ``build_lsr_train_step(param_specs=,
             zero_specs=)``, the specs from
             ``state_shardings(transformer_param_specs(...))`` and the
             state cut from the same seeded one by ``shard_state``: each
             rank's state bytes equal to the specs' count (1.83 GB at
             (1, 2), 2.45 GB at (2, 1), beside the replicated 3.67 GB),
             step 1's loss within SHARDED_LOSS_RTOL of the unsharded
             step's, the params and the first moments after step 1
             gathered by ``gather_state`` against (a)/(b)'s (each leaf's
             update and each leaf's moments within (b)'s moment limit;
             whether the bits are equal printed), every block the same
             bits on the ranks that hold it after each step, K1-K3 2 x
             n_micro a step on "tma" at V 125001 and 250002; each rank's
             step ms (CUDA events), collectives' ms and bytes and peak
             memory beside (a)/(b)'s; then K1-K3 timed at
             train_16 on rank 1's vocab rows and on the whole
             vocabulary. Two ranks on one card over gloo measure no
             multi-card scaling. ``python3 chip_smoke.py --only
             sharded`` runs the device and build phases, the xlmr
             gradient check and this phase.

Every K1 launch of the serve, dense-serve, engine, pruned, frontier, train,
eval (b), xlmr (its serving phases too), sharded_engine, ckpt,
example_serve, decoder, moe, train_decoder, dryrun and sharded phases must
take the "tma" path. Then a
``timeline`` line (each phase's seconds, against the 1200 s the script
is given), a ``{"kernels": [...]}`` line and, last, ``{"ok": true,
"device": ...}``.
Any mismatch, exception or missing launch exits non-zero before that last
line. The script imports nothing of JAX nor of the JAX package.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))


def peak_rate(kind: str) -> float:
    """The H100 SXM data sheet's peak (dense, at the 700 W limit;
    ``repro_torch.launch.cost_analysis``): a product kind's FLOP/s
    (``"bf16"``, ``"tf32"``, ``"f32"``), or ``"bytes"``: HBM's bytes/s."""
    from repro_torch.launch import cost_analysis as ca

    return ca.HBM_BYTES_PER_S if kind == "bytes" else ca.PEAK_FLOPS[kind]


K1_TOL = 1e-4     # f32 sums over D in another order (both sides f32)
# K2/K3 against their plain versions: f32 sums over V (dH) or B (dE, db)
# in another order, relative to the largest |value| of each output
BWD_TOL = 1e-5
# K6 against its plain version: f32 sums over D in another order (fixed
# chains of FMAs against cuBLAS's blocked sums), relative to 1 + |score|;
# ids may differ only where the two candidates' scores are that close
K6_TOL = 1e-4


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# --------------------------------------------------------------------------
# 1. device
# --------------------------------------------------------------------------

def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    cap = torch.cuda.get_device_capability(0)
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         capability=list(cap), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    require(tuple(cap) == (9, 0), f"compute capability {cap}, need (9, 0)")


# --------------------------------------------------------------------------
# 2. build
# --------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    seconds = time.perf_counter() - t0
    reports = {}
    for name in _build.SOURCES:
        log = (_build.build_dir() / f"{name}.log")
        lines = log.read_text().splitlines() if log.exists() else []
        reports[name] = [ln.strip() for ln in lines
                         if any(word in ln for word in (
                             "Compiling entry", "registers", "spill",
                             "arning"))]
    emit("build", seconds=seconds, dir=str(_build.build_dir()),
         ptxas=reports)


# --------------------------------------------------------------------------
# 3. kernels against their plain versions
# --------------------------------------------------------------------------

K1_SHAPES = [  # (B, S, D, V): tests/test_kernels_sparton.py SHAPES, plus
    (1, 16, 8, 16), (4, 96, 64, 200), (3, 33, 24, 100),   # a D that is
    (8, 128, 128, 256), (2, 256, 32, 512), (3, 33, 20, 100),  # not % 8,
    (6, 32, 64, 200), (5, 20, 48, 130),   # 4 batch rows per block (S <= 32,
    (10, 12, 32, 150),                    # as served queries), and 8 (S <= 16)
]


BWD_SHAPES = [  # K2/K3 beside K1_SHAPES: an odd D (no 16-byte loads), a
    (3, 40, 13, 77),    # long sequence, a D whose last 256-column piece
    (2, 900, 40, 50),   # is partial, and one past a warp's 768 columns
    (3, 20, 300, 77),   # (two column blocks)
    (2, 33, 1000, 300),
]
# K2/K3 on the routings of ``reroute`` (a trained model's, and the extremes
# of K2's buckets), at full width (D 768, V 30522), at an odd D, and at D
# 1000 (two column blocks; one_position's buckets go to K2's helpers in
# four pieces, the last partial)
BWD_ROUTINGS = ("sparse", "skewed", "one_position", "empty_buckets")
BWD_ROUTING_SHAPES = [(6, 64, 768, 30522), (3, 40, 13, 77),
                      (2, 24, 1000, 2100)]


def k1_inputs(torch, B, S, D, V, dtype, seed, *, mask_p=0.2):
    g = torch.Generator(device="cuda").manual_seed(seed)
    H = torch.randn((B, S, D), generator=g, device="cuda").to(dtype)
    E = (torch.randn((V, D), generator=g, device="cuda") * 0.2).to(dtype)
    b = torch.randn((V,), generator=g, device="cuda") * 0.2
    mask = (torch.rand((B, S), generator=g, device="cuda") > mask_p).int()
    mask[:, 0] = 1
    return H, E, b, mask


def k1_expected_path(torch, H, E):
    """The K1 path the rule in ``kernels/sparton._plan`` must give, stated
    here on its own: TMA needs bf16, D % 8 == 0 and 16-byte aligned
    bases."""
    if H.dtype == torch.float32:
        return "f32"
    aligned = H.data_ptr() % 16 == 0 and E.data_ptr() % 16 == 0
    return "tma" if H.shape[2] % 8 == 0 and aligned else "wmma"


def reset_k1(k1):
    k1.sparton_forward.launches = 0
    k1.sparton_forward.path_launches = dict.fromkeys(k1.PATHS, 0)


def k1_on_tma(k1, where):
    """The K1 launches by path since ``reset_k1``; every one must have
    taken the "tma" path."""
    paths = dict(k1.sparton_forward.path_launches)
    require(k1.sparton_forward.launches > 0
            and paths["tma"] == k1.sparton_forward.launches,
            f"{where}: K1 launches by path {paths}, every one must take "
            f"'tma'")
    return paths


def k1_compare(torch, H, E, b, mask, softcap, *, exact_imax=False):
    """Kernel (launched twice) vs plain on one input: max |dy|, i_max
    mismatches and those beyond a near-tie (the two positions' logits
    differ by more than K1_TOL: the sums run in another order), the path
    taken (which must be the one ``k1_expected_path`` gives) and whether
    the two launches gave the same bits. ``exact_imax`` requires every
    i_max to equal the plain version's."""
    from repro_torch.kernels import sparton as k1

    before = dict(k1.sparton_forward.path_launches)
    y_k, i_k = k1.sparton_forward(H, E, b, mask, softcap=softcap)
    y_2, i_2 = k1.sparton_forward(H, E, b, mask, softcap=softcap)
    y_p, i_p = k1.sparton_forward_plain(H, E, b, mask, softcap)
    torch.cuda.synchronize()
    taken = [path for path, n in k1.sparton_forward.path_launches.items()
             if n != before[path]]
    want = k1_expected_path(torch, H, E)
    require(taken == [want], f"K1 at {tuple(H.shape)} {H.dtype} took "
                             f"{taken}, expected {want!r}")
    err = (y_k - y_p).abs()
    require(bool((err <= K1_TOL + K1_TOL * y_p.abs()).all()),
            f"K1 y differs from the plain version by {err.max().item()}")
    bad = (i_k != i_p).nonzero()
    hard = 0
    if bad.numel():
        bb, vv = bad[:, 0], bad[:, 1]
        Hf, Ef = H.float(), E.float()

        def logit(s):
            z = (Hf[bb, s.long()] * Ef[vv]).sum(-1) + b[vv]
            return softcap * torch.tanh(z / softcap) if softcap else z

        gap = (logit(i_k[bb, vv]) - logit(i_p[bb, vv])).abs()
        hard = int((gap > K1_TOL * (1 + logit(i_p[bb, vv]).abs())).sum())
    if exact_imax:
        hard = int(bad.shape[0])
    return {"path": want, "max_abs_err": float(err.max()),
            "imax_mismatch": int(bad.shape[0]), "imax_hard": hard,
            "bit_identical": bool(torch.equal(y_k, y_2)
                                  and torch.equal(i_k, i_2))}


def k4_cases(torch):
    """(name, w, docs, n_docs, k, term_lanes) with weights that are small
    multiples of 1/8, so every sum is exact whatever its order and the
    kernel must match the plain version bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(4)
    cases = []

    def window(B, Q, L, n_docs, density):
        docs = torch.stack([torch.stack([
            torch.randperm(n_docs, generator=g, device="cuda")[:L]
            for _ in range(Q)]) for _ in range(B)]).int()
        w = torch.randint(1, 17, (B, Q, L), generator=g,
                          device="cuda").float() / 8
        w = w * (torch.rand((B, Q, L), generator=g, device="cuda")
                 < density)
        return w.reshape(B, -1).contiguous(), docs.reshape(B, -1).contiguous()

    w, d = window(6, 16, 40, 5000, 0.5)
    cases.append(("random", w, d, 5000, 10, 40))
    w, d = window(3, 4, 3, 1000, 1.0)           # 12 matches, k = 50
    cases.append(("zero_score_ties", w, d, 1000, 50, 3))
    w, d = window(2, 2, 2, 5, 1.0)
    cases.append(("k_gt_n_docs", w, d, 5, 8, 2))
    z = torch.zeros((3, 0), device="cuda")
    cases.append(("w_empty", z, z.int(), 64, 7, 1))
    w, d = window(4, 8, 16, 300, 1.0)
    w[1] = 0
    w[3] = 0
    cases.append(("empty_rows", w.contiguous(), d, 300, 12, 16))
    w, d = window(2, 8, 200, 70000, 0.7)        # three doc tiles
    cases.append(("multi_tile", w, d, 70000, 100, 200))
    return cases


def k5_index_case(torch, n_docs, postings, vocab, q_terms, q_vals, seed):
    """K5's inputs from a quantized index built on the card: ``postings``
    maps a term to its doc ids (random impacts); each query row holds
    ``q_terms`` with weights ``q_vals``. Returns (windows, n_docs, quant,
    queries)."""
    from repro_torch.retrieval.engine.quantize import (_fused_q_windows,
                                                       quantize_index)
    from repro_torch.retrieval.index import build_inverted_index
    from repro_torch.retrieval.sparse_rep import SparseRep

    rng = np.random.default_rng(seed)
    v = np.zeros((n_docs, len(postings)), np.float32)   # a slot per term
    i = np.zeros((n_docs, len(postings)), np.int32)
    for slot, (term, ds) in enumerate(sorted(postings.items())):
        v[ds, slot] = rng.uniform(0.2, 3.0, len(ds))
        i[ds, slot] = term
    rep = SparseRep(v, i, (v > 0).sum(1).astype(np.int32))
    quant = quantize_index(build_inverted_index(rep, vocab, device="cuda"))
    q_vals = np.asarray(q_vals, np.float32)
    q = SparseRep(q_vals, np.asarray(q_terms, np.int32),
                  (q_vals > 0).sum(1).astype(np.int32))
    return _fused_q_windows(q, quant), n_docs, quant, q


def k5_random_index(torch, n_docs, nnz, vocab, B, Q, seed):
    """A random corpus of ``nnz`` distinct terms a doc, quantized on the
    card, and B queries of Q terms (one padded slot, one absent term)."""
    from repro_torch.retrieval.engine.quantize import (_fused_q_windows,
                                                       quantize_index)
    from repro_torch.retrieval.index import build_inverted_index
    from repro_torch.retrieval.sparse_rep import SparseRep

    g = torch.Generator(device="cuda").manual_seed(seed)
    i = torch.rand((n_docs, vocab - 1), generator=g,
                   device="cuda").argsort(dim=1)[:, :nnz].int()
    v = torch.rand((n_docs, nnz), generator=g, device="cuda") * 2 + 0.1
    quant = quantize_index(build_inverted_index(
        SparseRep(v, i, torch.full((n_docs,), nnz, device="cuda")), vocab,
        device="cuda"))
    qi = torch.randint(0, vocab, (B, Q), generator=g, device="cuda").int()
    qi[:, -1] = vocab - 1                       # a term no doc holds
    qv = torch.rand((B, Q), generator=g, device="cuda") + 0.2
    qv[0, 1] = 0.0                              # a padded slot
    q = SparseRep(qv, qi, (qv > 0).sum(1).int())
    return _fused_q_windows(q, quant), n_docs, quant, q


def k5_random_windows(torch, B, Q, L, n_docs, max_gap, seed):
    """Gathered windows as the wrapper may see them: odd and even starts,
    garbage past each term's length, empty terms, qv <= 0 columns, code-0
    lanes, and gaps >= 1 so no doc repeats within a term."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device="cuda",
                             dtype=torch.int32)

    lens = ints(0, L + 1, (B, Q))
    if Q:
        lens[0, 0] = 0
    qv = torch.rand((B, Q), generator=g, device="cuda") * 2.5 - 0.5
    if Q > 2:
        qv[:, 2] = 0.0
    return (ints(0, 256, (B, Q, L)), ints(1, max_gap + 1, (B, Q, L)),
            ints(0, 1 << 20, (B, Q)), lens, qv,
            torch.rand((B, Q), generator=g, device="cuda"),
            torch.rand((B, Q), generator=g, device="cuda") / 14)


def k5_cases(torch):
    """(name, windows, n_docs, k, index): quantized indexes built on the
    card (u8 and u16 deltas, escape phantoms whose gap is an exact multiple
    of the escape and so share a doc with the next posting, n_docs over
    the old kernel's 32768-doc tile; ``index`` = (queries, quant) for the
    in-place entry), a query of 130 terms (``long_query_case``) and random
    windows (several 512-lane chunks per term, empty terms, qv <= 0,
    k > n_docs, L = 0, Q = 0; ``index`` None)."""
    from repro_torch.retrieval.engine.quantize import (_fused_q_windows,
                                                       quantize_index)

    cases = []
    wins, n, quant, q = k5_index_case(
        torch, 2000, {3: np.r_[np.arange(64), 777, 1901],
                      5: [0, 255, 765, 1020], 6: np.arange(0, 2000, 3)},
        16, [[3, 5, 6, 7], [5, 3, 7, 6]], [[1.0, 0.7, 0.4, 0.5],
                                          [2.0, 0.0, 0.5, 1.0]], 1)
    assert quant.deltas.dtype == torch.uint8 and quant.n_postings > \
        quant.n_source_postings, "the u8 case lost its phantoms"
    cases.append(("index_u8_phantoms", wins, n, 70, (q, quant)))
    wins, n, quant, q = k5_index_case(
        torch, 131072 + 1, {3: [0, 65535, 131070],
                            4: np.arange(7, 131072, 20000)},
        8, [[3, 4]], [[1.0, 0.5]], 2)
    assert quant.deltas.dtype == torch.uint16 and quant.n_postings > \
        quant.n_source_postings, "the u16 case lost its phantoms"
    cases.append(("index_u16_phantoms_multi_tile", wins, n, 5, (q, quant)))
    wins, n, quant, q = k5_random_index(torch, 3000, 16, 256, 6, 12, 3)
    assert quant.deltas.dtype == torch.uint8
    cases.append(("random_index_u8", wins, n, 20, (q, quant)))
    wins, n, quant, q = k5_random_index(torch, 20000, 4, 4096, 4, 8, 4)
    assert quant.deltas.dtype == torch.uint16
    cases.append(("random_index_u16", wins, n, 10, (q, quant)))
    # i32 term_lens (a list of 2**16 or more postings), k past 1024
    wins, n, quant, q = k5_index_case(
        torch, 70000, {2: np.arange(0, 70000, 1), 9: np.arange(5, 70000, 7)},
        12, [[2, 9, 11], [9, 2, 0]], [[0.5, 1.5, 1.0], [1.0, 0.0, 2.0]], 5)
    assert quant.term_lens.dtype == torch.int32
    cases.append(("index_i32_lens_k1100", wins, n, 1100, (q, quant)))
    q, index = long_query_case(torch, 43)
    quant = quantize_index(index)
    cases.append(("index_long_query_three_chunks",
                  _fused_q_windows(q, quant), index.n_docs, 100, (q, quant)))
    q, index = ids_outside_vocab_case(torch, 46)
    quant = quantize_index(index)
    cases.append(("index_ids_outside_vocab", _fused_q_windows(q, quant),
                  index.n_docs, 15, (q, quant)))
    for name, (B, Q, L, n, gap, k) in {
            "windows_three_chunks": (6, 10, 1500, 5000, 3, 50),
            "windows_k_gt_n_docs": (2, 3, 4, 7, 2, 12),
            "windows_multi_tile": (2, 6, 600, 70000, 230, 100),
            "windows_L0": (3, 4, 0, 64, 1, 7),
            "windows_Q0": (2, 0, 5, 64, 1, 7)}.items():
        cases.append((name, k5_random_windows(torch, B, Q, L, n, gap,
                                              len(cases)), n, k, None))
    return cases


def runs_vs_plain(torch, run, plain):
    """A kernel entry, launched twice, against its plain version: whether
    values and ids are equal and whether the two launches agree bit for
    bit. Returns the comparison and the first launch's result."""
    runs = [run() for _ in range(2)]
    v_p, i_p = plain()
    torch.cuda.synchronize()
    v_k, i_k = runs[0]
    err = float((v_k - v_p).abs().max()) if v_k.numel() else 0.0
    return {"max_abs_err": err, "id_mismatch": int((i_k != i_p).sum()),
            "equal": bool(torch.equal(v_k, v_p) and torch.equal(i_k, i_p)),
            "bit_identical": all(bool(torch.equal(a, b))
                                 for a, b in zip(*runs))}, runs[0]


def k5_index_args(quant, queries):
    """K5's in-place arguments: the queries' (B, Q) columns and the
    quantized index's arrays as stored."""
    from repro_torch.retrieval.sparse_rep import query_columns

    return (*query_columns(queries, quant.device), quant.term_starts,
            quant.term_lens, quant.packed_vals, quant.deltas, quant.term_lo,
            quant.term_hi)


def k5_index_compare(torch, queries, quant, k, window_result=None):
    """K5 reading ``quant`` in place, launched twice, against its plain
    version, and (``window_result``) equal to the window entry's result on
    the same queries' windows."""
    from repro_torch.kernels import impact_score as k45

    args = k5_index_args(quant, queries)
    kw = dict(n_docs=quant.n_docs, k=k)
    case, got = runs_vs_plain(
        torch, lambda: k45.fused_quantized_index_topk(*args, **kw),
        lambda: k45.fused_quantized_index_topk_plain(*args, **kw))
    if window_result is not None:
        case["equal_window"] = all(bool(torch.equal(a, b))
                                   for a, b in zip(got, window_result))
    return case


def k5_compare(torch, wins, n_docs, k):
    """K5 on windows, launched twice, against its plain version on one
    input: whether values and ids are equal (the decode and the order of
    the sums are the same) and whether the two launches agree bit for
    bit; and the first launch's result."""
    from repro_torch.kernels.impact_score import (fused_quantized_topk,
                                                  fused_quantized_topk_plain)

    return runs_vs_plain(
        torch, lambda: fused_quantized_topk(*wins, n_docs=n_docs, k=k),
        lambda: fused_quantized_topk_plain(*wins, n_docs=n_docs, k=k))


def random_index_case(torch, n_docs, nnz, vocab, B, Q):
    """(queries, index): an inverted index built on the card from random
    reps (``nnz`` distinct terms a doc, none the last term), queries with
    a padded slot, a term no doc holds, a row of weights <= 0 and an empty
    row."""
    from repro_torch.retrieval.index import build_inverted_index
    from repro_torch.retrieval.sparse_rep import SparseRep

    g = torch.Generator(device="cuda").manual_seed(n_docs + B)
    i = torch.rand((n_docs, vocab - 1), generator=g,
                   device="cuda").argsort(dim=1)[:, :nnz].int()
    v = torch.rand((n_docs, nnz), generator=g, device="cuda") * 2 + 0.1
    rep = SparseRep(v, i, torch.full((n_docs,), nnz, device="cuda"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the stopword-like lists
        index = build_inverted_index(rep, vocab, device="cuda")
    qi = torch.randint(0, vocab, (B, Q), generator=g, device="cuda").int()
    qi[:, -1] = vocab - 1                   # a term no doc holds
    qv = torch.rand((B, Q), generator=g, device="cuda") + 0.2
    qv[0, min(1, Q - 1)] = 0.0              # a padded slot
    if B > 2:
        qv[1] = -qv[1]                      # weights <= 0: skipped
        qv[2] = 0.0                         # an empty row
    return SparseRep(qv, qi, (qv > 0).sum(1).int()), index


def k4_index_cases(torch):
    """(name, queries, index, k): ``random_index_case`` with k from 1 past
    n_docs, n_docs from 5 to 70000 (one slice to many); and a query of 130
    terms (``long_query_case``)."""
    cases = []
    for name, (n_docs, nnz, vocab, B, Q, k) in {
            "tiny_k_gt_n_docs": (5, 2, 8, 3, 2, 8),
            "one_slice": (300, 8, 100, 2, 5, 1),
            "random": (3000, 16, 256, 6, 12, 20),
            "serve_width": (16384, 64, 30522, 8, 64, 10),
            "serve_width_B64": (16384, 64, 30522, 64, 64, 10),
            "k1100": (2000, 32, 512, 3, 28, 1100),
            "many_slices": (70000, 8, 2000, 2, 6, 100),
            "long_lists": (20000, 6, 40, 4, 8, 50)}.items():
        cases.append((name, *random_index_case(torch, n_docs, nnz, vocab, B,
                                               Q), k))
    cases.append(("long_query_three_chunks", *long_query_case(torch, 41),
                  20))
    cases.append(("ids_outside_vocab", *ids_outside_vocab_case(torch, 45),
                  15))
    return cases


# K4's ceiling entry (tier 1 of the pruned path): the candidate budgets
# C + 1 of k 10 (65, 129 when the lists are skewed) and of k 64 (257), past
# the slice kernel's k <= 32 threshold path; at the engine's width, with
# fewer docs reached than k (the list filled by zero-ceiling docs), k past
# n_docs, one slice and many
CEILING_CASES = {  # name: (n_docs, nnz, vocab, B, Q, k)
    "k65": (20480, 64, 30522, 8, 64, 65),
    "k129": (20480, 64, 30522, 8, 64, 129),
    "k257": (20480, 64, 30522, 8, 64, 257),
    "k257_B64": (20480, 64, 30522, 64, 64, 257),
    "zero_fill": (3000, 4, 5000, 3, 4, 300),
    "k_gt_n_docs": (50, 4, 64, 3, 5, 65),
    "many_slices": (70000, 8, 2000, 2, 6, 129),
}


def k4_ceiling_gates(torch):
    """K4's ceiling entry, launched twice, against its plain version: bit
    for bit on ``CEILING_CASES``, a 130-term query (past two 64-term
    chunks) and ids outside [0, V). Returns the cases."""
    from repro_torch.kernels import impact_score as k45
    from repro_torch.retrieval.sparse_rep import query_columns

    inputs = [(name, *random_index_case(torch, *shape[:5]), shape[5])
              for name, shape in CEILING_CASES.items()]
    inputs.append(("long_query_three_chunks", *long_query_case(torch, 41),
                   129))
    inputs.append(("ids_outside_vocab", *ids_outside_vocab_case(torch, 45),
                   65))
    cases = []
    for name, queries, index, k in inputs:
        args = (*query_columns(queries, index.device), index.term_starts,
                index.term_lens, index.postings_doc, index.term_ubs)
        kw = dict(n_docs=index.n_docs, k=k)
        case, got = runs_vs_plain(
            torch, lambda: k45.fused_ceiling_index_topk(*args, **kw),
            lambda: k45.fused_ceiling_index_topk_plain(*args, **kw))
        vals = got[0][:, :min(k, index.n_docs)]
        cases.append({"case": name, "n_docs": index.n_docs, "k": k,
                      "B": args[0].shape[0], "Q": args[0].shape[1],
                      "zero_ceilings_in_list": int((vals == 0).sum()),
                      **case})
    bad = [c for c in cases if not (c["equal"] and c["bit_identical"])]
    require(not bad, f"K4's ceiling entry differs from its plain version "
                     f"or between two launches: {bad[:2]}")
    require(any(c["zero_ceilings_in_list"] for c in cases),
            "no ceiling case filled its list with zero-ceiling docs")
    return cases


def ids_outside_vocab_case(torch, seed, n_docs=3000, nnz=16, vocab=256,
                           B=6, Q=12):
    """(queries, index): a random index built on the card and queries
    whose ids lie at and past V and below 0 (down to -2V), which the
    kernels and their plain versions read by the reference's gather rule
    (a negative id plus V, then clamped to [0, V - 1]), beside ordinary
    ids and a padded slot."""
    from repro_torch.retrieval.index import build_inverted_index
    from repro_torch.retrieval.sparse_rep import SparseRep

    g = torch.Generator(device="cuda").manual_seed(seed)
    i = torch.rand((n_docs, vocab), generator=g,
                   device="cuda").argsort(dim=1)[:, :nnz].int()
    v = torch.rand((n_docs, nnz), generator=g, device="cuda") * 2 + 0.1
    rep = SparseRep(v, i, torch.full((n_docs,), nnz, device="cuda"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        index = build_inverted_index(rep, vocab, device="cuda")
    qi = torch.randint(-2 * vocab, 2 * vocab, (B, Q), generator=g,
                       device="cuda").int()
    qi[:, :4] = torch.tensor([vocab, -1, -vocab, -vocab - 1],
                             dtype=torch.int32, device="cuda")
    qv = torch.rand((B, Q), generator=g, device="cuda") + 0.2
    qv[0, 5] = 0.0                              # a padded slot
    return SparseRep(qv, qi, (qv > 0).sum(1).int()), index


def long_query_case(torch, seed, n_docs=20000, nnz=16, vocab=400, B=4,
                    Q=130):
    """(queries, index): every doc holds term 0 (a list of n_docs
    postings, several of the kernel's staging rounds) and nnz - 1 other
    distinct terms; each query row holds Q distinct terms, past two of the
    kernel's 64-term chunks (the third partly filled), term 0 at slot 70
    (in the second chunk), a padded slot, and row 1's first 64 weights
    <= 0. The inverted index is built on the card."""
    from repro_torch.retrieval.index import build_inverted_index
    from repro_torch.retrieval.sparse_rep import SparseRep

    g = torch.Generator(device="cuda").manual_seed(seed)
    rest = torch.rand((n_docs, vocab - 1), generator=g,
                      device="cuda").argsort(dim=1)[:, :nnz - 1] + 1
    i = torch.cat([torch.zeros((n_docs, 1), dtype=rest.dtype,
                               device="cuda"), rest], 1).int()
    v = torch.rand((n_docs, nnz), generator=g, device="cuda") * 2 + 0.1
    rep = SparseRep(v, i, torch.full((n_docs,), nnz, device="cuda"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # term 0 is in every doc
        index = build_inverted_index(rep, vocab, device="cuda")
    qi = (torch.rand((B, vocab - 1), generator=g,
                     device="cuda").argsort(dim=1)[:, :Q] + 1).int()
    qi[:, 70] = 0
    qv = torch.rand((B, Q), generator=g, device="cuda") + 0.2
    qv[0, 3] = 0.0                              # a padded slot
    qv[1, :64] = -qv[1, :64]                    # a chunk of skipped terms
    return SparseRep(qv, qi, (qv > 0).sum(1).int()), index


def k4_index_compare(torch, queries, index, k):
    """K4 reading ``index`` in place, launched twice, against its plain
    version, and equal to the window entry on the same queries' windows
    (a window batch read as an index)."""
    from repro_torch.kernels import impact_score as k45
    from repro_torch.retrieval.score import _fused_windows
    from repro_torch.retrieval.sparse_rep import query_columns

    args = (*query_columns(queries, index.device), index.term_starts,
            index.term_lens, index.postings_doc, index.postings_val)
    kw = dict(n_docs=index.n_docs, k=k)
    case, got = runs_vs_plain(
        torch, lambda: k45.fused_impact_index_topk(*args, **kw),
        lambda: k45.fused_impact_index_topk_plain(*args, **kw))
    w, docs = _fused_windows(queries, index)
    window = k45.fused_impact_topk(w, docs, n_docs=index.n_docs, k=k,
                                   term_lanes=index.max_postings)
    case["equal_window"] = all(bool(torch.equal(a, b))
                               for a, b in zip(got, window))
    return case


K6_SHAPES = [  # (B, N, D, k): tests/test_kernels_topk.py shapes, an odd D
    (1, 100, 16, 5), (3, 500, 32, 10), (8, 1024, 64, 100), (2, 999, 8, 7),
    (3, 301, 13, 9),                          # (4-byte loads), k == N and
    (3, 10, 8, 10), (3, 10, 8, 16), (3, 7, 8, 12),   # k > N (a NEG_INF tail),
    (8, 3000, 2500, 10), (3, 1000, 1201, 7),  # D over several query chunks,
    (5, 20000, 31, 256), (9, 70000, 24, 256),  # k = 256 over many tiles, the
    (40, 5000, 33, 20), (40, 3000, 700, 10),   # 16-, 32- and 64-row query
    (70, 3000, 50, 64), (66, 2000, 20, 200),   # tiles of the tensor-core
    (12, 4000, 300, 10), (16, 2500, 77, 33),   # path (B > 8, an odd D too),
    (0, 50, 6, 4),                             # B = 0, and past the old
    (5, 20000, 31, 257), (40, 5000, 33, 300),  # limit of 256: lists merged
    (20, 100, 8, 300), (70, 3000, 50, 1000),   # in passes, k > N, pass 1's
    (9, 200000, 8, 2000),                      # lists in the workspace
    (10, 20000, 4, 20000),                     # (B > 8), pass 2's (k = N),
    (2, 1000000, 4, 3000),                     # and stream_kernel's (B <= 8)
]


def k6_cases(torch):
    """(name, q, C, k, exact): random normal inputs at K6_SHAPES, and the
    same shapes with entries in {-3..3}, where every sum is exact whatever
    its order and the kernel must match the plain version bit for bit;
    then all-negative scores, duplicated candidate rows (exact ties) and a
    corpus whose base is not 8-byte aligned."""
    g = torch.Generator(device="cuda").manual_seed(6)

    def normal(B, N, D):
        return (torch.randn((B, D), generator=g, device="cuda"),
                torch.randn((N, D), generator=g, device="cuda"))

    def ints(B, N, D):
        return tuple(torch.randint(-3, 4, shape, generator=g,
                                   device="cuda").float()
                     for shape in ((B, D), (N, D)))

    cases = []
    for B, N, D, k in K6_SHAPES:
        cases.append((f"normal_{B}x{N}x{D}_k{k}", *normal(B, N, D), k, False))
        cases.append((f"ints_{B}x{N}x{D}_k{k}", *ints(B, N, D), k, True))
    q = torch.rand((2, 16), generator=g, device="cuda") + 0.5
    C = -(torch.rand((700, 16), generator=g, device="cuda") + 0.5)
    cases.append(("all_negative", q, C, 9, False))
    q, C = ints(2, 96, 8)
    C[60:84] = C[0:24]
    cases.append(("duplicate_rows", q, C, 12, True))
    q, C = normal(5, 3000, 30)
    C = torch.cat([C.new_zeros(1), C.reshape(-1)])[1:].view(C.shape)
    cases.append(("unaligned_corpus", q, C, 10, False))
    return cases


def k6_compare(torch, q, C, k, exact):
    """K6, launched twice, against its plain version on one input: max
    |value| difference (also relative to 1 + |value|, K6_TOL's measure),
    ids that differ, ids that differ beyond a near-tie
    (the two candidates' plain scores more than K6_TOL apart), whether the
    values are within K6_TOL (bit for bit when ``exact``) and whether the
    two launches agree bit for bit."""
    from repro_torch.kernels.topk_score import topk_score, topk_score_plain

    runs = [topk_score(q, C, k=k) for _ in range(2)]
    v_p, i_p = topk_score_plain(q, C, k=k)
    torch.cuda.synchronize()
    v_k, i_k = runs[0]
    out = {"bit_identical": all(bool(torch.equal(a, b))
                                for a, b in zip(*runs))}
    if v_k.numel() == 0:
        return {**out, "max_abs_err": 0.0, "max_rel_err": 0.0,
                "id_mismatch": 0, "id_hard": 0, "within_tol": True}
    err = (v_k - v_p).abs()
    differ = i_k != i_p
    hard = 0
    if bool(differ.any()):
        scores = q @ C.T
        s_k = scores.gather(1, i_k.long())
        s_p = scores.gather(1, i_p.long())
        near = (s_k - s_p).abs() <= K6_TOL * (1 + s_p.abs())
        hard = int((differ & ~near).sum())
    ok = (bool((err == 0).all()) and not bool(differ.any()) if exact
          else bool((err <= K6_TOL * (1 + v_p.abs())).all()))
    return {**out, "max_abs_err": float(err.max()),
            "max_rel_err": float((err / (1 + v_p.abs())).max()),
            "id_mismatch": int(differ.sum()), "id_hard": hard,
            "within_tol": ok and hard == 0}


# Past the port's old limits, each at the limit + 1 (and the limit itself):
# K2 at S = 1729 and 2048, past the 1728 rows that its first design's
# shared-memory accumulator held (B 2, D 768, V 30522, bf16 as the train
# step runs it); K1, K2 and K3 at B = 65536, past the 65535 rows of a
# grid's y dimension, on a narrow head.
LONG_S = [(2, 1728, 768, 30522), (2, 1729, 768, 30522),
          (2, 2048, 768, 30522)]
WIDE_B = (65536, 8, 8, 64)
# K2 launched with a longer seq_len than i_max reaches: its rows below S
# must be the bits of the shorter launch, the rest zero
TILED_S = 3500
# K2's routing pass where a row's list no longer fits shared memory beside
# its counts (V 60000: placed straight into device memory), and where its
# counts do not fit either (S 60000: counted in device memory)
ROUTE_SPILL = [(2, 16, 8, 60000), (1, 60000, 8, 64)]


def limit_cases(torch):
    """K2 past 1728 positions and K1/K2/K3 past 65535 batch rows, each
    against its plain version (K2/K3 within BWD_TOL and bit for bit across
    two launches; at B = 65536 and ROUTE_SPILL also against the dense
    oracle); K2 launched for TILED_S positions gives the bits of the
    S-position launch below S and zeros above."""
    from repro_torch.kernels import sparton_bwd as kb

    rows = []
    for (B, S, D, V) in LONG_S:
        H, E, mask, dy, y, i_max = bwd_inputs(torch, B, S, D, V,
                                              torch.bfloat16, S, None,
                                              last_wins=True)
        case = bwd_compare(torch, H, E, mask, dy, y, i_max, None)
        dh = kb.sparton_backward_dh(dy, y, i_max, E, S)
        tiled = kb.sparton_backward_dh(dy, y, i_max, E, TILED_S)
        torch.cuda.synchronize()
        case["tiled_bits_equal"] = bool(
            torch.equal(tiled[:, :S], dh) and (tiled[:, S:] == 0).all())
        case["imax_max"] = int(i_max.max())
        rows.append({"kernel": "K2/K3", "shape": [B, S, D, V], **case})
        del H, E, dy, y, i_max, dh, tiled
    for (B, S, D, V) in ROUTE_SPILL:
        H, E, mask, dy, y, i_max = bwd_inputs(torch, B, S, D, V,
                                              torch.bfloat16, 67, None)
        rows.append({"kernel": "K2/K3", "shape": [B, S, D, V],
                     **bwd_compare(torch, H, E, mask, dy, y, i_max, None,
                                   oracle=True)})
    B, S, D, V = WIDE_B
    for dtype in (torch.float32, torch.bfloat16):
        H, E, b, mask = k1_inputs(torch, B, S, D, V, dtype, 65)
        case = k1_compare(torch, H, E, b, mask, None)
        rows.append({"kernel": "K1", "shape": [B, S, D, V],
                     "dtype": str(dtype)[6:], **case,
                     "within_tol": case["imax_hard"] == 0})
        H, E, mask, dy, y, i_max = bwd_inputs(torch, B, S, D, V, dtype, 66,
                                              None)
        rows.append({"kernel": "K2/K3", "shape": [B, S, D, V],
                     "dtype": str(dtype)[6:],
                     **bwd_compare(torch, H, E, mask, dy, y, i_max, None,
                                   oracle=True)})
    torch.cuda.empty_cache()
    bad = [r for r in rows if not (r["within_tol"]
                                   and r.get("bit_identical", True)
                                   and r.get("tiled_bits_equal", True))]
    require(not bad, f"past the old limits: {bad[:2]}")
    require(all(r["imax_max"] == r["shape"][1] - 1 for r in rows
                if "imax_max" in r), "no term routed to the last row")
    return rows


# K1 at full width (D 768, V 30522 with its 58-column tail, bf16, so the
# "tma" path): chunks that end inside the TMA box (S 48, 900, 1729), B x S
# not a multiple of 128, 8 batch rows to a tile with B = 5, each with and
# without the softcap and with a fully masked row. (B, S, softcap)
K1_FULL = [(3, 48, None), (3, 48, 5.0), (2, 900, None), (2, 900, 5.0),
           (2, 1729, None), (5, 16, 5.0)]
# K1 on exact ties at full width: every row of H a copy of one of a few
# distinct rows, placed at random (so first copies fall in any warp,
# warpgroup or chunk), and small-integer H, E and bias, so that every
# logit is exact in f32 whatever the order of the sums: i_max must equal
# the plain version's everywhere. (B, S, distinct rows, softcap)
K1_TIES = [(4, 300, 24, None), (4, 300, 24, 5.0), (5, 40, 6, None),
           (9, 12, 4, 5.0)]
# K1 at full width on masks that empty whole chunks of 128 positions, as
# padded batches do: in both row groups of a cluster's pair or in one
# only, an odd number of row groups, and every position but the last
# masked. {name: (B, S, lengths or None, rows whose chunk 1 is masked)}
K1_CHUNKS = {
    "lengths_at_chunk_edges": (4, 300, [128, 129, 256, 1], []),
    "pair_rows_split": (4, 384, [384, 100, 40, 300], []),
    "middle_chunk_in_some_rows": (4, 384, None, [0, 1, 2]),
    "odd_row_groups": (3, 256, [256, 90, 30], []),
    "only_the_last_position": (2, 300, None, []),
}


def k1_chunk_mask(torch, name):
    B, S, lengths, middle = K1_CHUNKS[name]
    pos = torch.arange(S, device="cuda")
    if lengths is not None:
        return (pos < torch.tensor(lengths, device="cuda")[:, None]).int()
    mask = torch.ones((B, S), dtype=torch.int32, device="cuda")
    mask[middle, 128:256] = 0
    if name == "only_the_last_position":
        mask.zero_()
        mask[:, -1] = 1
    return mask


def k1_tie_inputs(torch, B, S, distinct, seed):
    D, V = 768, 30522
    g = torch.Generator(device="cuda").manual_seed(seed)

    def ternary(shape, density):
        keep = torch.rand(shape, generator=g, device="cuda") < density
        sign = torch.randint(0, 2, shape, generator=g, device="cuda") * 2 - 1
        return (keep * sign).to(torch.bfloat16)

    rows = ternary((B, distinct, D), 0.1)
    pick = torch.randint(0, distinct, (B, S), generator=g, device="cuda")
    H = torch.gather(rows, 1, pick[:, :, None].expand(B, S, D)).contiguous()
    E = ternary((V, D), 0.1)
    b = torch.randint(-4, 5, (V,), generator=g, device="cuda") / 4.0
    mask = (torch.rand((B, S), generator=g, device="cuda") > 0.2).int()
    mask[:, 0] = 1
    mask[B - 1] = 0
    return H, E, b, mask


def k1_gates(torch):
    """K1 against its plain version, each case launched twice (the same
    bits) on the path the rule gives: K1_SHAPES in f32 and bf16 with and
    without the softcap, a bf16 H whose base is not 16-byte aligned
    ("wmma"), K1_FULL, the masks of K1_CHUNKS and the exact ties of
    K1_TIES ("tma"), and a fully masked row giving (0, 0)."""
    from repro_torch.kernels.sparton import sparton_forward

    cases = []
    seed = 0
    for (B, S, D, V) in K1_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for softcap in (None, 5.0):
                seed += 1
                H, E, b, mask = k1_inputs(torch, B, S, D, V, dtype, seed)
                if B > 1:
                    mask[B - 1] = 0          # one fully masked row
                cases.append({"shape": [B, S, D, V],
                              "dtype": str(dtype)[6:], "softcap": softcap,
                              **k1_compare(torch, H, E, b, mask, softcap)})
    # a bf16 H whose base is not 16-byte aligned: the "wmma" path, with
    # element copies (no cp.async)
    H, E, b, mask = k1_inputs(torch, 4, 96, 64, 200, torch.bfloat16, 98)
    H = torch.cat([H.new_zeros(1), H.reshape(-1)])[1:].view(H.shape)
    cases.append({"shape": [4, 96, 64, 200], "dtype": "bfloat16",
                  "softcap": None, "unaligned": True,
                  **k1_compare(torch, H, E, b, mask, None)})
    for i, (B, S, softcap) in enumerate(K1_FULL):
        H, E, b, mask = k1_inputs(torch, B, S, 768, 30522, torch.bfloat16,
                                  200 + i)
        mask[B - 1] = 0
        cases.append({"shape": [B, S, 768, 30522], "dtype": "bfloat16",
                      "softcap": softcap,
                      **k1_compare(torch, H, E, b, mask, softcap)})
        del H, E
    for i, name in enumerate(K1_CHUNKS):
        B, S = K1_CHUNKS[name][:2]
        for softcap in (None, 5.0):
            H, E, b, _ = k1_inputs(torch, B, S, 768, 30522, torch.bfloat16,
                                   400 + i)
            mask = k1_chunk_mask(torch, name)
            cases.append({"shape": [B, S, 768, 30522], "dtype": "bfloat16",
                          "softcap": softcap, "masked_chunks": name,
                          **k1_compare(torch, H, E, b, mask, softcap)})
            del H, E
    for i, (B, S, distinct, softcap) in enumerate(K1_TIES):
        H, E, b, mask = k1_tie_inputs(torch, B, S, distinct, 300 + i)
        cases.append({"shape": [B, S, 768, 30522], "dtype": "bfloat16",
                      "softcap": softcap, "exact_ties": distinct,
                      **k1_compare(torch, H, E, b, mask, softcap,
                                   exact_imax=True)})
        del H, E
    torch.cuda.empty_cache()
    bad = [c for c in cases if c["imax_hard"] or not c["bit_identical"]]
    require(not bad, f"K1 i_max disagrees beyond near-ties (exactly, on "
                     f"the ties) or two launches differ: {bad[:2]}")
    # a fully masked row gives y = 0, i_max = 0 on both sides
    H, E, b, mask = k1_inputs(torch, 3, 33, 24, 100, torch.bfloat16, 99)
    mask[1] = 0
    y, i = sparton_forward(H, E, b, mask)
    require(bool((y[1] == 0).all() and (i[1] == 0).all()),
            "K1 fully masked row is not (0, 0)")
    return cases


def phase_kernels(torch):
    from repro_torch.kernels.impact_score import (fused_impact_topk,
                                                  fused_impact_topk_plain)

    k1 = k1_gates(torch)
    k4 = []
    for name, w, d, n_docs, k, lanes in k4_cases(torch):
        case, _ = runs_vs_plain(
            torch, lambda: fused_impact_topk(w, d, n_docs=n_docs, k=k,
                                             term_lanes=lanes),
            lambda: fused_impact_topk_plain(w, d, n_docs=n_docs, k=k,
                                            term_lanes=lanes))
        k4.append({"case": name, "entry": "window", **case})
    for name, q, index, k in k4_index_cases(torch):
        k4.append({"case": name, "entry": "index", "n_docs": index.n_docs,
                   "k": k, **k4_index_compare(torch, q, index, k)})
    bad = [c for c in k4 if not (c["equal"] and c["bit_identical"]
                                 and c.get("equal_window", True))]
    require(not bad, f"K4 differs from its plain version, between two "
                     f"launches or between its entries: {bad[:2]}")
    k4_ceiling = k4_ceiling_gates(torch)
    k5 = []
    for name, wins, n, k, index in k5_cases(torch):
        case, got = k5_compare(torch, wins, n, k)
        k5.append({"case": name, "entry": "window",
                   "shape": list(wins[0].shape), "n_docs": n, "k": k,
                   **case})
        if index is not None:
            k5.append({"case": name, "entry": "index", "n_docs": n, "k": k,
                       "delta_dtype": str(index[1].deltas.dtype)[6:],
                       "lens_dtype": str(index[1].term_lens.dtype)[6:],
                       **k5_index_compare(torch, *index, k, got)})
    bad = [c for c in k5 if not (c["equal"] and c["bit_identical"]
                                 and c.get("equal_window", True))]
    require(not bad, f"K5 differs from its plain version, between two "
                     f"launches or between its entries: {bad[:2]}")
    k6 = []
    for name, q, C, k, exact in k6_cases(torch):
        k6.append({"case": name, "exact": exact,
                   **k6_compare(torch, q, C, k, exact)})
    dup = next(c for c in k6 if c["case"] == "duplicate_rows")
    bad = [c for c in k6 if not (c["within_tol"] and c["bit_identical"])]
    require(not bad, f"K6 differs from the plain version beyond {K6_TOL} "
                     f"or between two launches: {bad[:2]}")
    require(dup["id_mismatch"] == 0, "K6 duplicate rows: ties not to the "
                                     "lowest id")
    bwd = []
    seed = 100
    for (B, S, D, V) in K1_SHAPES + BWD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for softcap in (None, 5.0):
                seed += 1
                H, E, mask, dy, y, i_max = bwd_inputs(
                    torch, B, S, D, V, dtype, seed, softcap)
                case = bwd_compare(torch, H, E, mask, dy, y, i_max, softcap,
                                   oracle=True)
                bwd.append({"shape": [B, S, D, V], "dtype": str(dtype)[6:],
                            "softcap": softcap, **case})
    for (B, S, D, V) in BWD_ROUTING_SHAPES:
        for kind in BWD_ROUTINGS:
            seed += 1
            H, E, mask, dy, y, i_max = bwd_inputs(
                torch, B, S, D, V, torch.bfloat16, seed, None)
            y, i_max = reroute(torch, y, i_max, S, kind,
                               torch.Generator(device="cuda").manual_seed(seed))
            case = bwd_compare(torch, H, E, mask, dy, y, i_max, None,
                               oracle=True)
            bwd.append({"shape": [B, S, D, V], "dtype": "bfloat16",
                        "routing": kind, **case})
    bad = [c for c in bwd if not (c["within_tol"] and c["bit_identical"])]
    require(not bad, f"K2/K3 differ from the plain versions or the "
                     f"oracle beyond {BWD_TOL} or between two launches: "
                     f"{bad[:2]}")
    limits = limit_cases(torch)
    emit("kernels", k1_max_abs_err=max(c["max_abs_err"] for c in k1),
         k1_tol=K1_TOL,
         k1_imax_mismatch=sum(c["imax_mismatch"] for c in k1),
         k1_paths={path: sum(c["path"] == path for c in k1)
                   for path in ("tma", "wmma", "f32")},
         k1_bit_identical=all(c["bit_identical"] for c in k1),
         k1_cases=k1, k4_max_abs_err=max(c["max_abs_err"] for c in k4),
         k4_id_mismatch=sum(c["id_mismatch"] for c in k4),
         k4_bit_identical=all(c["bit_identical"] for c in k4),
         k4_cases=k4,
         k4_ceiling_bit_identical=all(c["equal"] and c["bit_identical"]
                                      for c in k4_ceiling),
         k4_ceiling_cases=k4_ceiling, k5_max_abs_err=max(c["max_abs_err"] for c in k5),
         k5_id_mismatch=sum(c["id_mismatch"] for c in k5),
         k5_bit_identical=all(c["bit_identical"] for c in k5),
         k5_cases=k5, k6_tol=K6_TOL,
         k6_max_abs_err=max(c["max_abs_err"] for c in k6),
         k6_id_mismatch=sum(c["id_mismatch"] for c in k6),
         k6_id_hard=sum(c["id_hard"] for c in k6),
         k6_bit_identical=all(c["bit_identical"] for c in k6),
         k6_cases=k6, bwd_tol=BWD_TOL,
         k2_max_abs_err=max(c["dH"] for c in bwd),
         k3_max_abs_err=max(max(c["dE"], c["db"]) for c in bwd),
         k23_oracle_max_abs_err=max(c["oracle"] for c in bwd),
         bwd_bit_identical=all(c["bit_identical"] for c in bwd),
         bwd_cases=bwd, limit_cases=limits)


def bwd_inputs(torch, B, S, D, V, dtype, seed, softcap, *, last_wins=False):
    """K1's inputs with one position that wins the max for many columns
    (a shared i_max; with ``last_wins`` also the last position, so that
    terms route to the end of a long sequence), a block of columns held at
    y == 0 by their bias, a fully masked row; (y, i_max) from K1 and a
    random cotangent."""
    from repro_torch.kernels.sparton import sparton_forward

    H, E, b, mask = k1_inputs(torch, B, S, D, V, dtype, seed)
    H[0, min(1, S - 1)] *= 20
    if last_wins:
        H[0, S - 1] *= 20
        mask[0, S - 1] = 1
    b[:max(1, V // 8)] = -100.0
    if B > 1:
        mask[B - 1] = 0
    y, i_max = sparton_forward(H, E, b, mask, softcap=softcap)
    g = torch.Generator(device="cuda").manual_seed(seed)
    dy = torch.randn((B, V), generator=g, device="cuda")
    return H, E, mask, dy, y, i_max


def bwd_compare(torch, H, E, mask, dy, y, i_max, softcap, *, oracle=False):
    """K2 and K3, launched twice, against their plain versions on one
    input: max |dH|, |dE|, |db| differences, whether they are within
    BWD_TOL of the largest |value|, whether the two launches agree bit
    for bit, and whether fully masked rows got dH == 0. With ``oracle``
    (small shapes: it holds the (B, V, S) one-hot routing), also against
    the dense oracle ``kernels.ref.sparton_backward_fused_ref``, which
    shares no code with the plain versions."""
    from repro_torch.kernels import sparton_bwd as kb
    from repro_torch.kernels.ref import sparton_backward_fused_ref

    S = H.shape[1]
    runs = [(kb.sparton_backward_dh(dy, y, i_max, E, S, softcap=softcap),
             *kb.sparton_backward_de(dy, y, i_max, H, softcap=softcap))
            for _ in range(2)]
    plain = (kb.sparton_backward_dh_plain(dy, y, i_max, E, S, softcap),
             *kb.sparton_backward_de_plain(dy, y, i_max, H, softcap))
    torch.cuda.synchronize()
    out, ok = {}, True
    for name, got, ref in zip(("dH", "dE", "db"), runs[0], plain):
        err = float((got - ref).abs().max())
        out[name] = err
        ok = ok and err <= BWD_TOL * (1 + float(ref.abs().max()))
    if oracle:
        dense = sparton_backward_fused_ref(dy, y, i_max, H, E, softcap)
        out["oracle"] = max(float((got - ref).abs().max())
                            for got, ref in zip(runs[0], dense))
        ok = ok and all(
            float((got - ref).abs().max()) <= BWD_TOL * (
                1 + float(ref.abs().max()))
            for got, ref in zip(runs[0], dense))
    out["bit_identical"] = all(bool(torch.equal(a, b))
                               for a, b in zip(*runs))
    dead = ~mask.bool().any(dim=1)
    out["masked_rows_zero"] = bool((runs[0][0][dead] == 0).all())
    out["within_tol"] = ok and out["masked_rows_zero"]
    return out


# --------------------------------------------------------------------------
# 4. serve at full width
# --------------------------------------------------------------------------

SERVE = {"corpus": 16384, "requests": 64, "index_batch": 64, "topk": 10,
         "rep_topk": 64}
# fused vs impact, streaming vs dense or fused: the same products summed in
# another order, relative to 1 + |score|
SCORE_TOL = 1e-4


@contextlib.contextmanager
def patched(wrap, **targets):
    """Replace each callable ``name=(owner, attribute)`` by ``wrap(name,
    callable)`` for the block; restores them on exit."""
    saved = [(owner, attr, getattr(owner, attr))
             for owner, attr in targets.values()]
    for name, (owner, attr, fn) in zip(targets, saved):
        setattr(owner, attr, wrap(name, fn))
    try:
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


@contextlib.contextmanager
def plain_guard(**targets):
    """Wrap each plain version ``name=(module, attribute)`` so that a call
    on a CUDA tensor is recorded: the main path must never run one.
    Yields the list of names so recorded; restores them on exit."""
    hits = []

    def wrap(name, fn):
        def wrapped(x, *a, **kw):
            if x.is_cuda:
                hits.append(name)
            return fn(x, *a, **kw)
        return wrapped

    with patched(wrap, **targets):
        yield hits


K45_ENTRIES = {  # launch counter: entry
    "impact_topk": "fused_impact_topk",
    "impact_index_topk": "fused_impact_index_topk",
    "impact_ceiling_topk": "fused_ceiling_index_topk",
    "impact_q_topk": "fused_quantized_topk",
    "impact_q_index_topk": "fused_quantized_index_topk",
}


def reset_k45(k45):
    for entry in K45_ENTRIES.values():
        getattr(k45, entry).launches = 0


def k45_launches(k45):
    """K4's and K5's calls on the card since ``reset_k45``: each kernel's
    total over its window and index entries ("impact_topk",
    "impact_q_topk"), the index entries' own counts, and K4's ceiling
    entry's ("impact_ceiling_topk", the pruned path's tier 1: in neither
    total)."""
    n = {key: getattr(k45, entry).launches
         for key, entry in K45_ENTRIES.items()}
    return {"impact_topk": n["impact_topk"] + n["impact_index_topk"],
            "impact_index_topk": n["impact_index_topk"],
            "impact_ceiling_topk": n["impact_ceiling_topk"],
            "impact_q_topk": n["impact_q_topk"] + n["impact_q_index_topk"],
            "impact_q_index_topk": n["impact_q_index_topk"]}


def k45_plains(k45):
    """plain_guard targets: the plain version of every K4/K5 entry."""
    return {f"{entry}_plain": (k45, f"{entry}_plain")
            for entry in K45_ENTRIES.values()}


def phase_serve(torch, config=None, phase="serve"):
    """The sparse serving path at full width for ``config`` (splade_bert's
    CONFIG unless given), the kernel head with ``rep_topk`` 64."""
    import dataclasses

    from repro_torch.configs.splade_bert import CONFIG
    from repro_torch.kernels import impact_score as k4
    from repro_torch.kernels import sparton as k1
    from repro_torch.launch.serve import run
    from repro_torch.models.transformer import init_params
    from repro_torch.retrieval.score import impact_scores, retrieve
    from repro_torch.runtime.serving import (FailedResult, ShedResult,
                                             make_config_encoder)

    cfg = dataclasses.replace(config or CONFIG, rep_topk=SERVE["rep_topk"])
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    encode = make_config_encoder(params, cfg)
    batches = []   # (B, S, seconds) of every encode call

    def timed_encode(tokens, mask):
        t0 = time.perf_counter()
        reps = encode(tokens, mask)
        torch.cuda.synchronize()
        batches.append((tokens.shape[0], tokens.shape[1],
                        time.perf_counter() - t0))
        return reps

    reset_k1(k1)
    reset_k45(k4)
    with plain_guard(k1=(k1, "sparton_forward_plain"),
                     **k45_plains(k4)) as plain_on_cuda:
        res = run(timed_encode, cfg.vocab_size, corpus=SERVE["corpus"],
                  requests=SERVE["requests"], topk=SERVE["topk"],
                  method="auto", index_batch=SERVE["index_batch"],
                  device=torch.device("cuda"))
    launches = {"sparton_fwd": k1.sparton_forward.launches,
                **k45_launches(k4)}
    k1_paths = k1_on_tma(k1, phase)

    st = res["loop"].stats()
    unserved = [r for r in res["outcomes"].values()
                if isinstance(r, (ShedResult, FailedResult))]
    require(not unserved, f"{len(unserved)} requests not served "
                          f"({st['shed']} shed, {st['failed']} failed): "
                          f"{unserved[:2]!r}")
    require(res["method"] == "fused",
            f"auto resolved to {res['method']!r}, not 'fused'")
    require(launches["sparton_fwd"] == len(batches),
            f"K1 launched {launches['sparton_fwd']} times for "
            f"{len(batches)} encode batches")
    require(launches["impact_topk"] >= 1
            and launches["impact_topk"] == launches["impact_index_topk"],
            f"K4 launched {launches}: the fused retrieve reads the index "
            f"in place")
    require(not plain_on_cuda, f"plain versions ran on CUDA tensors: "
                               f"{sorted(set(plain_on_cuda))}")
    for rep in res["served"]:
        require(rep.width == SERVE["rep_topk"] and rep.nnz > 0
                and bool((rep.values >= 0).all()), "malformed query rep")

    # fused ids against the plain impact path on the same queries; the
    # impact path sums each doc in term order, so two runs of it on the
    # card give the same bits
    queries, index = res["queries"], res["index"]
    k = res["idx"].shape[1]
    v_i, i_i = retrieve(queries, index, k, method="impact")
    again = retrieve(queries, index, k, method="impact")
    scores = impact_scores(queries, index)
    impact_bits = (torch.equal(v_i, again[0]) and torch.equal(i_i, again[1])
                   and torch.equal(scores, impact_scores(queries, index)))
    require(impact_bits, f"{phase}: two impact retrievals differ")
    rows = torch.arange(scores.shape[0], device="cuda")[:, None]
    s_f = scores[rows, res["idx"].long()]
    s_i = scores[rows, i_i.long()]
    differ = res["idx"] != i_i
    near = (s_f - s_i).abs() <= SCORE_TOL * (1 + s_i.abs())
    require(bool((near | ~differ).all()),
            "fused ids differ from impact ids beyond near-ties")
    require(bool(torch.isfinite(res["vals"]).all()), "non-finite scores")
    val_err = float((res["vals"] - v_i).abs().max())
    require(val_err <= SCORE_TOL * (1 + float(v_i.abs().max())),
            f"fused scores differ from impact by {val_err}")

    n_query = len(res["loop"].batch_sizes)
    doc_ms = sorted(1e3 * t for _, _, t in batches[:-n_query])
    query_ms = [1e3 * t for _, _, t in batches[-n_query:]]
    lat = res["loop"].latencies()
    ist = index.stats()
    emit(phase, config=cfg.name, n_params=cfg.n_params,
         head_impl=cfg.head_spec().impl, launches=launches,
         k1_paths=k1_paths,
         encode_batches=len(batches), index_s=res["index_s"],
         index_build_s=res["index_s"] - sum(doc_ms) / 1e3,
         index_memory_bytes=ist["memory_bytes"],
         n_docs=ist["n_docs"], n_postings=ist["n_postings"],
         active_terms=ist["active_terms"], max_postings=ist["max_postings"],
         doc_batch_ms_median=doc_ms[len(doc_ms) // 2],
         query_batch_ms=query_ms, query_batches=list(res["loop"].batch_sizes),
         serve_s=res["serve_s"],
         p50_latency_ms=1e3 * float(np.percentile(lat, 50)),
         p99_latency_ms=1e3 * float(np.percentile(lat, 99)),
         retrieve_method=res["method"], retrieve_ms=1e3 * res["retrieve_s"],
         ids_differ=int(differ.sum()), near_ties=int((differ & near).sum()),
         fused_vs_impact_max_abs_err=val_err,
         impact_bit_identical=impact_bits)
    return {"params": params, "cfg": cfg, "res": res, "launches": launches,
            "k1_paths": k1_paths}


def index_as_dense(torch, index):
    """The (n_docs, V) f32 matrix an inverted index holds: each posting's
    weight at (doc, term)."""
    terms = torch.repeat_interleave(
        torch.arange(index.vocab_size, device=index.device),
        index.term_lens.long())
    n = terms.numel()
    dense = torch.zeros((index.n_docs, index.vocab_size),
                        dtype=torch.float32, device=index.device)
    dense[index.postings_doc[:n].long(), terms] = index.postings_val[:n]
    return dense


def ids_beyond_near_ties(torch, scores, got, want):
    """Ids of ``got`` that differ from ``want`` at a position where their
    ``scores`` differ by more than SCORE_TOL; and how many differ at all."""
    got, want = got.long(), want.long()
    s_g, s_w = scores.gather(1, got), scores.gather(1, want)
    differ = got != want
    near = (s_g - s_w).abs() <= SCORE_TOL * (1 + s_w.abs())
    return int((differ & ~near).sum()), int(differ.sum())


def phase_serve_dense(torch, served, phase="serve_dense", shared_gates=True):
    """The serving path with dense reps (``--rep-topk 0``): the sparse
    phase's weights, a (16384, V) f32 corpus, ``auto`` -> streaming (K6),
    held against the ``dense`` method; then, the served checks passed, the
    sparse phase's index as a second dense corpus, K6 on it against K4.
    With ``shared_gates``, K6 past its old limits (``dense_past_limits``:
    V does not change them, so the xlmr phase leaves them to the BERT
    one). The phase's peak device memory is printed."""
    import dataclasses

    from repro_torch.kernels import sparton as k1
    from repro_torch.kernels import topk_score as k6
    from repro_torch.launch.serve import run
    from repro_torch.retrieval.score import impact_scores, retrieve
    from repro_torch.runtime.serving import (FailedResult, ShedResult,
                                             make_config_encoder)

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(served["cfg"], rep_topk=None)
    encode = make_config_encoder(served["params"], cfg)
    batches = []

    def counted_encode(tokens, mask):
        batches.append(tokens.shape)
        return encode(tokens, mask)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_k1(k1)
    k6.topk_score.launches = 0
    with plain_guard(k1=(k1, "sparton_forward_plain"),
                     k6=(k6, "topk_score_plain")) as plain_on_cuda:
        res = run(counted_encode, cfg.vocab_size, corpus=SERVE["corpus"],
                  requests=SERVE["requests"], topk=SERVE["topk"],
                  method="auto", index_batch=SERVE["index_batch"],
                  device=torch.device("cuda"))
    launches = {"sparton_fwd": k1.sparton_forward.launches,
                "topk_score": k6.topk_score.launches}
    k1_paths = k1_on_tma(k1, phase)

    corpus, st = res["index"], res["loop"].stats()
    unserved = [r for r in res["outcomes"].values()
                if isinstance(r, (ShedResult, FailedResult))]
    require(not unserved, f"{len(unserved)} dense requests not served "
                          f"({st['shed']} shed, {st['failed']} failed)")
    require(res["method"] == "streaming",
            f"auto resolved to {res['method']!r}, not 'streaming'")
    require(launches["sparton_fwd"] == len(batches),
            f"K1 launched {launches['sparton_fwd']} times for "
            f"{len(batches)} encode batches")
    require(launches["topk_score"] >= 1, "K6 never launched")
    require(not plain_on_cuda, f"plain versions ran on CUDA tensors: "
                               f"{sorted(set(plain_on_cuda))}")
    require(tuple(corpus.shape) == (SERVE["corpus"], cfg.vocab_size)
            and corpus.dtype == torch.float32 and corpus.is_cuda,
            f"dense corpus {tuple(corpus.shape)} {corpus.dtype}")
    require(bool(torch.isfinite(corpus).all() and (corpus >= 0).all()),
            "dense corpus has negative or non-finite entries")
    for row in res["served"]:
        require(row.shape == (cfg.vocab_size,) and np.isfinite(row).all()
                and (row >= 0).all(), "malformed dense query row")

    # K6 (auto -> streaming) against the dense method on the same queries
    queries = res["queries"].cuda()
    k = res["idx"].shape[1]
    v_d, i_d = retrieve(queries, corpus, k, method="dense")
    scores = queries @ corpus.T
    hard, differ = ids_beyond_near_ties(torch, scores, res["idx"], i_d)
    require(bool(torch.isfinite(res["vals"]).all()), "non-finite scores")
    require(hard == 0, f"streaming ids differ from dense ids beyond "
                       f"near-ties at {hard} positions")
    val_err = float((res["vals"] - v_d).abs().max())
    require(val_err <= SCORE_TOL * (1 + float(v_d.abs().max())),
            f"streaming scores differ from dense by {val_err}")

    # K6 against K4 on the sparse phase's reps: the same index as a dense
    # (N, V) corpus, the same SparseRep queries
    sparse = served["res"]
    sparse_docs = index_as_dense(torch, sparse["index"])
    v_s, i_s = retrieve(sparse["queries"], sparse_docs, k, method="streaming")
    del sparse_docs
    torch.cuda.empty_cache()
    exact = impact_scores(sparse["queries"], sparse["index"])
    hard_s, differ_s = ids_beyond_near_ties(torch, exact, i_s, sparse["idx"])
    require(hard_s == 0, f"streaming ids on the sparse reps differ from the "
                         f"fused ids beyond near-ties at {hard_s} positions")
    val_err_s = float((v_s - sparse["vals"]).abs().max())
    require(val_err_s <= SCORE_TOL * (1 + float(sparse["vals"].abs().max())),
            f"streaming scores on the sparse reps differ from fused by "
            f"{val_err_s}")

    shared = ({"past_limits": dense_past_limits(torch, res, corpus)}
              if shared_gates else {})
    lat = res["loop"].latencies()
    emit(phase, config=cfg.name, head_impl=cfg.head_spec().impl,
         launches=launches, encode_batches=len(batches),
         index_s=res["index_s"], corpus_shape=list(corpus.shape),
         corpus_mib=corpus.nbytes / 2**20, serve_s=res["serve_s"],
         p50_latency_ms=1e3 * float(np.percentile(lat, 50)),
         p99_latency_ms=1e3 * float(np.percentile(lat, 99)),
         retrieve_method=res["method"], retrieve_ms=1e3 * res["retrieve_s"],
         ids_differ_vs_dense=differ, streaming_vs_dense_max_abs_err=val_err,
         ids_differ_vs_fused=differ_s, streaming_vs_fused_max_abs_err=val_err_s,
         **shared, k1_paths=k1_paths,
         max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
         seconds=time.perf_counter() - t_phase)
    return {"res": res, "launches": launches, "k1_paths": k1_paths}


def dense_past_limits(torch, res, corpus):
    """K6 on the dense-serve corpus past its old limits, for the 8 served
    queries (stream_kernel) and all 64 served requests (the tensor-core
    path): k = 257 and 300, and k = 10 on a bf16 copy of the corpus and on
    a non-contiguous view of it (every other row), which the wrapper casts
    or copies once as the reference casts. Ids equal the ``dense``
    method's on the same corpus up to near-ties, scores within
    SCORE_TOL."""
    from repro_torch.retrieval.score import retrieve

    rows = []
    batches = {"B8": res["queries"].cuda(),
               "B64": torch.from_numpy(np.stack(res["served"])).cuda()}
    variants = [("k257", corpus, 257), ("k300", corpus, 300),
                ("bf16", None, SERVE["topk"]),
                ("strided", corpus[::2], SERVE["topk"])]
    for name, C, k in variants:
        if C is None:
            C = corpus.to(torch.bfloat16)
        for tag, q in batches.items():
            v_s, i_s = retrieve(q, C, k, method="streaming")
            v_d, i_d = retrieve(q, C, k, method="dense")
            scores = q @ C.float().T
            hard, differ = ids_beyond_near_ties(torch, scores, i_s, i_d)
            err = float((v_s - v_d).abs().max())
            rows.append({"case": f"{name}_{tag}", "k": k,
                         "corpus": [list(C.shape), str(C.dtype)[6:],
                                    C.is_contiguous()],
                         "ids_differ": differ, "ids_hard": hard,
                         "max_abs_err": err})
            require(tuple(i_s.shape) == (q.shape[0], k) and hard == 0
                    and err <= SCORE_TOL * (1 + float(v_d.abs().max())),
                    f"K6 past its old limits ({name}, {tag}): {rows[-1]}")
            del scores
        del C
    torch.cuda.empty_cache()
    return rows


ENGINE = {"corpus": 20480, "batch": 64, "remove_frac": 0.05}


def searched(torch, engine, queries, k):
    """``engine.search`` with auto, fused and quantized: each one's host
    results and ms, the per-slot scores the quantized method sums (the
    base's dequantized sums, the delta's impact sums) and the ids' slots,
    taken before the next mutation renumbers them, and the K4/K5 launches
    of each search."""
    from repro_torch.kernels import impact_score as k45
    from repro_torch.retrieval.engine.quantize import quantized_scores
    from repro_torch.retrieval.score import impact_scores

    builder = engine.builder
    out = {"launches": {}}
    for method in ("auto", "fused", "quantized"):
        reset_k45(k45)
        t0 = time.perf_counter()
        out[method] = engine.search(queries, k, method=method)
        out[method + "_ms"] = 1e3 * (time.perf_counter() - t0)
        out["launches"][method] = k45_launches(k45)
    parts = [quantized_scores(queries, builder._base)]
    if builder._delta is not None:
        parts.append(impact_scores(queries, builder._delta))
    out["scores"] = torch.cat(parts, dim=1)
    slot_of = np.vectorize(lambda e: builder._slot.get(int(e), -1),
                           otypes=[np.int64])
    out["slots"] = {m: slot_of(out[m][1])
                    for m in ("auto", "fused", "quantized")}
    return out


def held_to_quantized(torch, out, gone, tag):
    """Each search of ``searched`` against the quantized method's: finite
    scores, no padding, no tombstoned id (``gone``), ids equal beyond
    near-ties and scores within ``SCORE_TOL``. Returns a row per method."""
    v_q = out["quantized"][0]
    want = torch.from_numpy(out["slots"]["quantized"]).cuda()
    rows = {}
    for method in ("auto", "fused", "quantized"):
        vals, ext = out[method]
        require(bool(np.isfinite(vals).all()) and not (ext < 0).any()
                and not gone & set(ext.ravel().tolist()),
                f"{tag}{method}: non-finite scores, padding or tombstoned "
                f"ids")
        slots = torch.from_numpy(out["slots"][method]).cuda()
        require(bool((slots >= 0).all()),
                f"{tag}{method}: unknown external ids")
        hard, differ = ids_beyond_near_ties(torch, out["scores"], slots,
                                            want)
        require(hard == 0, f"{tag}{method} ids differ from the quantized "
                           f"method's beyond near-ties at {hard} positions")
        err = float(np.abs(vals - v_q).max())
        require(err <= SCORE_TOL * (1 + float(np.abs(v_q).max())),
                f"{tag}{method} scores differ from the quantized method's "
                f"by {err}")
        rows[method] = {"ids_differ": differ, "max_abs_err": err,
                        "search_ms": out[method + "_ms"],
                        "launches": out["launches"][method]}
    return rows


# The JAX package's compression acceptance corpus (tests/test_engine.py,
# BENCH): graded docs whose top-10 ids are the same under every method.
ACCEPT = {"n_docs": 1536, "vocab": 1536, "doc_nnz": 32, "n_queries": 8,
          "q_nnz": 28, "k": 10}


def acceptance_corpus(torch):
    """The reference's acceptance corpus indexed and quantized on the
    card: at least 4x smaller than its raw index, the quantized and fused
    (K5) ids equal to the exact impact ids, and K5 equal to its plain
    version on its windows."""
    from repro_torch.data.synthetic import lsr_impact_corpus
    from repro_torch.retrieval.engine.quantize import (_fused_q_windows,
                                                       quantize_index)
    from repro_torch.retrieval.index import build_inverted_index
    from repro_torch.retrieval.score import retrieve
    from repro_torch.retrieval.sparse_rep import sparsify_topk

    a, k = ACCEPT, ACCEPT["k"]
    data = lsr_impact_corpus(**{key: a[key] for key in (
        "n_docs", "vocab", "doc_nnz", "n_queries", "q_nnz")})
    raw = build_inverted_index(sparsify_topk(
        torch.from_numpy(data["docs"]).cuda(), a["doc_nnz"]), a["vocab"],
        device="cuda")
    quant = quantize_index(raw)
    q = sparsify_topk(torch.from_numpy(data["queries"]).cuda(), a["q_nnz"])
    ids = {m: retrieve(q, raw if m == "impact" else quant, k, method=m)[1]
           for m in ("impact", "quantized", "fused")}
    ratio = raw.memory_bytes() / quant.memory_bytes()
    require(ratio >= 4.0, f"the acceptance corpus is {ratio:.3f}x smaller "
                          f"quantized, below 4x")
    for m in ("quantized", "fused"):
        require(bool(torch.equal(ids[m], ids["impact"])),
                f"acceptance corpus: {m} ids differ from the impact ids")
    case, got = k5_compare(torch, _fused_q_windows(q, quant), quant.n_docs,
                           k)
    in_place = k5_index_compare(torch, q, quant, k, got)
    require(case["equal"] and case["bit_identical"] and in_place["equal"]
            and in_place["bit_identical"] and in_place["equal_window"],
            f"K5 on the acceptance corpus: {case}, in place {in_place}")
    return {"compression": ratio, "raw_memory_bytes": raw.memory_bytes(),
            "quantized_memory_bytes": quant.memory_bytes(),
            "delta_dtype": str(quant.deltas.dtype),
            "phantom_frac": quant.stats()["phantom_frac"],
            "ids_equal_impact": True, "k5": case, "k5_index": in_place}


def index_past_limits(torch, queries, raw, quant):
    """K4 on the engine's base as a raw index and K5 on the quantized base,
    past their old limit of 1024: k = 1025, 1100 and n_docs through
    ``retrieve(method="fused")``, whose ids must equal the exact method's
    (``impact``, ``quantized``) up to near-ties, scores within SCORE_TOL."""
    from repro_torch.kernels import impact_score as k45
    from repro_torch.retrieval.engine.quantize import quantized_scores
    from repro_torch.retrieval.score import impact_scores, retrieve

    rows = []
    for name, index, exact, scores_of, key in (
            ("K4", raw, "impact", impact_scores, "impact_topk"),
            ("K5", quant, "quantized", quantized_scores, "impact_q_topk")):
        scores = scores_of(queries, index)
        for k in (1025, 1100, index.n_docs):
            reset_k45(k45)
            v_f, i_f = retrieve(queries, index, k, method="fused")
            launched = k45_launches(k45)[key]
            v_e, i_e = retrieve(queries, index, k, method=exact)
            hard, differ = ids_beyond_near_ties(torch, scores, i_f, i_e)
            err = float((v_f - v_e).abs().max())
            rows.append({"kernel": name, "k": k, "n_docs": index.n_docs,
                         "launches": launched,
                         "ids_differ": differ, "ids_hard": hard,
                         "max_abs_err": err})
            require(rows[-1]["launches"] == 1 and
                    tuple(i_f.shape) == (queries.values.shape[0], k)
                    and hard == 0
                    and err <= SCORE_TOL * (1 + float(v_e.abs().max())),
                    f"{name} past its old limit: {rows[-1]}")
    return rows


def phase_serve_engine(torch, served, phase="serve_engine",
                       shared_gates=True):
    """The online index engine at full width: the serve phase's weights and
    queries, 20480 docs grown through ``CorpusEngine(quantize=True)`` one
    ``add_docs`` + ``flush`` per batch of 64, 5 % tombstoned, searched
    once with their postings zeroed in place by a plain ``flush``, then
    compacted away (19456 live docs in the base, above ``AUTO_FUSED_N``),
    one more batch as the delta; each time ``search`` with ``auto``,
    ``fused`` and ``quantized``. Then, with ``shared_gates`` (the gates
    that do not depend on V, which the xlmr phase leaves to the BERT one),
    the acceptance corpus and K4 and K5 past their old k limit."""
    from repro_torch.kernels import impact_score as k45
    from repro_torch.kernels import sparton as k1
    from repro_torch.launch.serve import SEED, grow_engine
    from repro_torch.retrieval.engine.quantize import (QuantizedIndex,
                                                       quantized_scores)
    from repro_torch.retrieval.score import retrieve
    from repro_torch.runtime.serving import (BatchedEncoder, BatchPolicy,
                                             CorpusEngine,
                                             make_config_encoder)

    t_phase = time.perf_counter()
    cfg, res = served["cfg"], served["res"]
    encode = make_config_encoder(served["params"], cfg)
    batches = []

    def counted_encode(tokens, mask):
        batches.append(tokens.shape)
        return encode(tokens, mask)

    engine = CorpusEngine(
        BatchedEncoder(counted_encode,
                       policy=BatchPolicy(max_batch=ENGINE["batch"])),
        cfg.vocab_size, quantize=True, device="cuda")
    builder, queries, k = engine.builder, res["queries"], SERVE["topk"]
    rng = np.random.default_rng(SEED)
    n = ENGINE["corpus"]
    reset_k1(k1)
    reset_k45(k45)
    engine_launches = {}
    with plain_guard(k1=(k1, "sparton_forward_plain"),
                     **k45_plains(k45)) as plain_on_cuda:
        t0 = time.perf_counter()
        grow_engine(engine, cfg.vocab_size, n, batch=ENGINE["batch"], rng=rng)
        torch.cuda.synchronize()
        engine_launches["grow"] = k45_launches(k45)
        index_s = time.perf_counter() - t0
        grown = engine.stats()
        dropped = rng.choice(n, size=int(ENGINE["remove_frac"] * n),
                             replace=False).tolist()
        require(engine.remove_docs(dropped) == len(dropped),
                "tombstoning removed fewer docs than asked")
        # the in-place path first: the tombstones' postings zeroed and the
        # base quantized again (what serve --engine --remove-frac runs)
        engine.flush()
        in_place = {"stats": engine.stats(),
                    "resolved": builder.resolved_method("auto"),
                    **searched(torch, engine, queries, k)}
        engine.flush(force_compact=True)
        base_raw, base = builder._base_raw, builder._base
        added = engine.add_docs([rng.integers(1, cfg.vocab_size, size=16)
                                 .astype(np.int32)
                                 for _ in range(ENGINE["batch"])])
        engine.flush()
        resolved = builder.resolved_method("auto")
        out = searched(torch, engine, queries, k)
    # the quantized method sums each doc in term order: two searches of
    # the base give the same bits; then each search's host time
    first, again = (retrieve(queries, base, k, method="quantized")
                    for _ in range(2))
    quantized_bits = (
        all(bool(torch.equal(a, b)) for a, b in zip(first, again))
        and torch.equal(quantized_scores(queries, base),
                        quantized_scores(queries, base)))
    require(quantized_bits, "two quantized searches differ")
    search_ms = {m: host_ms(torch, lambda: engine.search(queries, k,
                                                         method=m))
                 for m in ("auto", "fused", "quantized")}
    # the searches' launches: searched() counts each search from 0
    launches = {"sparton_fwd": k1.sparton_forward.launches,
                **{key: sum(row[method][key] for row in (
                    in_place["launches"], out["launches"])
                    for method in ("auto", "fused", "quantized"))
                   for key in ("impact_topk", "impact_q_topk")}}
    k1_paths = k1_on_tma(k1, phase)
    st = engine.stats()

    require(isinstance(base, QuantizedIndex) and st["quantized_base"],
            "the base segment is not quantized")
    require(st["base_docs"] == n - len(dropped)
            and st["delta_docs"] == ENGINE["batch"] and st["n_dead"] == 0,
            f"engine segments after the compaction and the last batch: {st}")
    require(resolved == "fused", f"auto on the base resolved to {resolved!r}")
    counts = {m: {key: c[key] for key in ("impact_q_topk", "impact_topk")}
              for m, c in out["launches"].items()}
    require(counts["auto"] == {"impact_q_topk": 1, "impact_topk": 0},
            f"auto search launched {counts['auto']}: K5 once on the base, "
            f"the {ENGINE['batch']}-doc delta on the plain impact path")
    require(counts["fused"] == {"impact_q_topk": 1, "impact_topk": 1},
            f"fused search launched {counts['fused']}, expected K5 and K4 "
            f"once each")
    require(counts["quantized"] == {"impact_q_topk": 0, "impact_topk": 0},
            f"the quantized method launched kernels: {counts['quantized']}")
    st_in = in_place["stats"]
    require(st_in["quantized_base"] and st_in["n_dead"] == len(dropped)
            and st_in["n_compactions"] == grown["n_compactions"],
            f"the tombstones were not zeroed in place: {st_in}")
    want = {"impact_q_topk": int(in_place["resolved"] == "fused"),
            "impact_topk": 0}
    got = {key: in_place["launches"]["auto"][key] for key in want}
    require(got == want,
            f"auto search on the zeroed base (resolved to "
            f"{in_place['resolved']!r}) launched "
            f"{in_place['launches']['auto']}, expected {want}")
    require(in_place["launches"]["fused"]["impact_q_topk"] == 1,
            f"fused search on the zeroed base launched "
            f"{in_place['launches']['fused']}, expected K5 once")
    require(launches["sparton_fwd"] == len(batches),
            f"K1 launched {launches['sparton_fwd']} times for "
            f"{len(batches)} encode batches")
    require(not plain_on_cuda, f"plain versions ran on CUDA tensors: "
                               f"{sorted(set(plain_on_cuda))}")
    require(engine_launches["grow"]["impact_topk"] == 0
            and engine_launches["grow"]["impact_q_topk"] == 0,
            f"growing the engine launched K4/K5: {engine_launches['grow']}")
    searches = [row[m] for row in (in_place["launches"], out["launches"])
                for m in ("auto", "fused", "quantized")]
    require(all(c["impact_topk"] == c["impact_index_topk"]
                and c["impact_q_topk"] == c["impact_q_index_topk"]
                for c in searches),
            f"the engine's searches used the window entries: {searches}")

    gone = set(dropped)
    rows_in_place = held_to_quantized(torch, in_place, gone, "in place: ")
    rows = held_to_quantized(torch, out, gone, "")
    shared = ({"acceptance": acceptance_corpus(torch),
               "past_limits": index_past_limits(torch, queries, base_raw,
                                                base)}
              if shared_gates else {})
    qs = base.stats()
    ratio = base_raw.memory_bytes() / base.memory_bytes()
    require(ratio > 1, f"the quantized base is not smaller than its raw "
                       f"index ({ratio:.3f}x)")
    emit(phase, config=cfg.name, launches=launches,
         k1_paths=k1_paths,
         encode_batches=len(batches), index_s=index_s,
         docs_grown=n, grown_stats=grown, removed=len(dropped),
         added_after_compaction=len(added), stats=st,
         n_compactions=st["n_compactions"], retrieve_method=resolved,
         base_docs=qs["n_docs"], base_postings=qs["n_postings"],
         phantom_frac=qs["phantom_frac"], max_postings=qs["max_postings"],
         delta_dtype=str(base.deltas.dtype),
         term_lens_dtype=str(base.term_lens.dtype),
         base_memory_bytes=qs["memory_bytes"],
         raw_memory_bytes=base_raw.memory_bytes(),
         compression=ratio, searches=rows, search_ms=search_ms,
         quantized_bit_identical=quantized_bits,
         in_place={"resolved": in_place["resolved"], "stats": st_in,
                   "searches": rows_in_place},
         **shared, seconds=time.perf_counter() - t_phase)
    return {"engine": engine, "launches": launches, "k1_paths": k1_paths}


PRUNED = {"corpus": 20480, "batch": 64, "remove_frac": 0.05,
          "margins": (0.5, 1.0), "ceiling_ks": (65, 129, 257)}


def ceiling_read_bytes(torch, qi, qv, index, k):
    """What a call of K4's ceiling entry must move, each byte once: the
    query rep's (B, Q) ids and weights, three columns of each distinct
    live query term (starts, lens, term_ubs), its postings' doc ids (4
    bytes each; no impact) and the (B, k) results. Returns (bytes,
    postings, terms)."""
    B, Q = qi.shape
    terms = torch.unique(qi[qv > 0].long())
    postings = int(index.term_lens[terms].long().sum())
    return (B * Q * 8 + terms.numel() * 12 + postings * 4 + B * k * 8,
            postings, terms.numel())


def time_ceiling(torch, queries, index, k, *, reps):
    """K4's ceiling entry on ``index`` at one batch: bit for bit its plain
    version and across two launches; device ms per call from CUDA-graph
    replays (``ms``), beside K4 reading the same index in place for the
    same queries at the same k and at the serve's k (``k4_ms``,
    ``k4_ms_topk``); CUDA-event times of the plain version and of the
    yardstick (``library_ms``: the ceiling windows, ``index_add_`` into
    (B, N), ``torch.topk``); the bound over the byte rate from
    ``ceiling_read_bytes``."""
    from repro_torch.kernels import impact_score as k45
    from repro_torch.retrieval.sparse_rep import query_columns

    qi, qv = query_columns(queries, index.device)
    n, L = index.n_docs, index.max_postings
    B = qi.shape[0]
    args = (qi, qv, index.term_starts, index.term_lens, index.postings_doc,
            index.term_ubs)
    k4_args = args[:5] + (index.postings_val,)
    kw = dict(n_docs=n, k=k)
    case, got = runs_vs_plain(
        torch, lambda: k45.fused_ceiling_index_topk(*args, **kw),
        lambda: k45.fused_ceiling_index_topk_plain(*args, **kw))
    require(case["equal"] and case["bit_identical"],
            f"K4's ceiling entry at B {B}, k {k}: {case}")
    rows = torch.arange(B, device=index.device)[:, None] * n

    def library():
        w, docs = k45.ceiling_windows(*args, L)
        flat = torch.zeros(B * n, device=index.device)
        flat.index_add_(0, (rows + docs.view(B, -1)).view(-1), w.view(-1))
        return torch.topk(flat.view(B, n), k, dim=1)

    nbytes, postings, terms = ceiling_read_bytes(torch, qi, qv, index, k)
    row = {"shape": {"B": B, "Q": qi.shape[1], "n_docs": n, "k": k}, **case,
           "digest": digest(*got), "postings_read": postings,
           "terms_read": terms, "bytes": nbytes,
           "bound_ms": 1e3 * nbytes / peak_rate("bytes"), "bound_by": "bytes"}
    row["ms"], row["ms_range"] = graph_ms(
        torch, lambda: k45.fused_ceiling_index_topk(*args, **kw), reps)
    row["k4_ms"], row["k4_ms_range"] = graph_ms(
        torch, lambda: k45.fused_impact_index_topk(*k4_args, **kw), reps)
    row["k4_ms_topk"], _ = graph_ms(
        torch, lambda: k45.fused_impact_index_topk(
            *k4_args, n_docs=n, k=SERVE["topk"]), reps)
    for key, fn in (("plain_ms",
                     lambda: k45.fused_ceiling_index_topk_plain(*args, **kw)),
                    ("library_ms", library)):
        row[key], row[key + "_range"] = timed(torch, fn, reps)
    return row


def pruned_searches(torch, engine, queries, k, gone, tag):
    """The engine's searches on ``queries`` with forward rows: ``auto``
    (twice: the same bits), ``impact``, ``fused``, ``pruned`` with
    ``candidates`` = the base's docs, and at each of PRUNED's margins;
    each one's K4 launches. Held to ``impact``: ids equal beyond
    near-ties (``ids_beyond_near_ties`` on the slots' exact scores), only
    the top-1 at a margin above 0; no padding, no tombstoned id
    (``gone``), finite scores. ``auto`` prunes each segment at margin 0
    with the default candidate budget, which the reference promises exact
    only on the rows where the pruning proves it (``exact_frontier``:
    every excluded doc's ceiling at most the k-th exact score); so its ids
    are held to ``impact``'s on the rows whose every segment's frontier
    holds, and on the others each returned score must be the exact score
    of its doc (tier 2's rescoring). The base's ``exact_frontier`` (its
    ``pruned_retrieve`` at margin 0), the delta's, and how many rows hold
    both are returned with the rows."""
    from repro_torch.kernels import impact_score as k45
    from repro_torch.retrieval.engine.pruning import (default_candidates,
                                                      pruned_retrieve)
    from repro_torch.retrieval.score import impact_scores

    builder = engine.builder
    base, delta = builder._base, builder._delta
    require(builder.resolved_method("auto") == "pruned",
            f"{tag}auto on the base resolved to "
            f"{builder.resolved_method('auto')!r}, not 'pruned'")
    n_pruned = 1 + (delta is not None)   # auto prunes the delta too
    plan = {"auto": ({}, n_pruned), "auto_again": ({}, n_pruned),
            "impact": ({"method": "impact"}, 0),
            "fused": ({"method": "fused"}, 0),
            "all_candidates": ({"method": "pruned",
                                "candidates": base.n_docs}, 1),
            **{f"margin_{m}": ({"method": "pruned", "prune_margin": m}, 1)
               for m in PRUNED["margins"]}}
    out = {}
    for name, (kw, ceilings) in plan.items():
        reset_k45(k45)
        vals, ext = engine.search(queries, k, **kw)
        launched = k45_launches(k45)
        require(launched["impact_ceiling_topk"] == ceilings,
                f"{tag}{name} search launched K4's ceiling entry "
                f"{launched['impact_ceiling_topk']} times, expected "
                f"{ceilings}: {launched}")
        require(bool(np.isfinite(vals).all()) and not (ext < 0).any()
                and not gone & set(ext.ravel().tolist()),
                f"{tag}{name}: non-finite scores, padding or tombstoned ids")
        out[name] = (vals, ext, launched)
    require(all(np.array_equal(a, b) for a, b in zip(out["auto"][:2],
                                                     out["auto_again"][:2])),
            f"{tag}two pruned searches differ")
    frontier = {}
    for seg_name, seg in (("base", base), ("delta", delta)):
        if seg is not None:
            frontier[seg_name] = pruned_retrieve(
                queries, seg, min(k, seg.n_docs),
                with_diagnostics=True)[2].cpu()
    exact_rows = torch.stack(list(frontier.values())).all(dim=0).cuda()
    scores = [impact_scores(queries, base)]
    if delta is not None:
        scores.append(impact_scores(queries, delta))
    scores = torch.cat(scores, dim=1)
    slot_of = np.vectorize(lambda e: builder._slot.get(int(e), -1),
                           otypes=[np.int64])
    want = torch.from_numpy(slot_of(out["impact"][1])).cuda()
    v_want = out["impact"][0]
    tol = SCORE_TOL * (1 + float(np.abs(v_want).max()))
    rows = {}
    for name, (vals, ext, launched) in out.items():
        got = torch.from_numpy(slot_of(ext)).cuda()
        cols = 1 if name.startswith("margin_") else k
        held = exact_rows if name.startswith("auto") else torch.ones_like(
            exact_rows)
        hard, differ = ids_beyond_near_ties(torch, scores[held],
                                            got[held, :cols],
                                            want[held, :cols])
        err = float(np.abs(vals[:, :cols] - v_want[:, :cols])[
            held.cpu().numpy()].max(initial=0.0))
        rescored = float((scores.gather(1, got).cpu()
                          - torch.from_numpy(vals)).abs().max())
        require(hard == 0 and err <= tol and rescored <= tol,
                f"{tag}{name}: ids differ from impact's beyond near-ties at "
                f"{hard} positions (of {cols} a row, on {int(held.sum())} "
                f"rows), scores by {err}; returned scores differ from "
                f"their docs' exact scores by {rescored}")
        rows[name] = {"ids_differ": differ, "compared_columns": cols,
                      "compared_rows": int(held.sum()), "max_abs_err": err,
                      "rescored_max_abs_err": rescored, "launches": launched}
        if not bool(held.all()):
            rows[name]["ids_differ_elsewhere"] = ids_beyond_near_ties(
                torch, scores[~held], got[~held, :cols],
                want[~held, :cols])[0]
    rows["exact_frontier"] = frontier["base"].tolist()
    rows["frontier_share"] = float(frontier["base"].float().mean())
    rows["delta_frontier_share"] = (float(frontier["delta"].float().mean())
                                    if "delta" in frontier else None)
    rows["exact_rows"] = int(exact_rows.sum())
    rows["candidates"] = default_candidates(base, min(k, base.n_docs))
    return rows


def pruned_split_ms(torch, queries, builder, k):
    """Host ms (``host_ms``: median of 30, each call ending in a
    synchronise) of the parts of an ``auto`` search on a pruned engine:
    on the base, tier 1 (K4's ceiling entry at C + 1), the query's dense
    (B, V + 1) scatter, tier 2 (that scatter, the gather of the
    candidates' forward rows, the exact sums and the top-k) and the whole
    pruned retrieve; the delta's own ``auto`` search."""
    from repro_torch.retrieval.engine import pruning as tp
    from repro_torch.retrieval.score import retrieve

    base, delta = builder._base, builder._delta
    k_base = min(k, base.n_docs)
    C = tp.default_candidates(base, k_base)
    n_top = min(C + 1, base.n_docs)
    ub_top, cand = tp.ceiling_topk(queries, base, n_top)

    def tier2():
        return tp.select_and_rescore(
            ub_top, cand, queries, base.doc_values, base.doc_indices,
            base.vocab_size, base.n_docs, k_base, C, 0.0)

    out = {"tier1": host_ms(torch, lambda: tp.ceiling_topk(queries, base,
                                                           n_top)),
           "query_scatter": host_ms(torch, lambda: tp.query_dense(
               queries, base.vocab_size, base.device)),
           "tier2": host_ms(torch, tier2),
           "base": host_ms(torch, lambda: retrieve(queries, base, k_base))}
    if delta is not None:
        out["delta"] = host_ms(torch, lambda: retrieve(
            queries, delta, min(k, delta.n_docs)))
    return out


def phase_serve_pruned(torch, served, phase="serve_pruned",
                       frontier_everywhere=True):
    """Two-tier pruned retrieval at full width: the serve phase's weights
    and queries (the 64 served requests), 20480 docs grown through
    ``CorpusEngine(keep_forward=True)`` one ``add_docs`` + ``flush`` per
    batch of 64, 5 % tombstoned and searched once zeroed in place, then
    compacted away, one more batch as the delta; each time
    ``pruned_searches`` (``auto`` resolving to ``pruned``, K4's ceiling
    entry once a pruned segment). Then K4's ceiling entry timed on the
    base (``time_ceiling``) at the search's budget C + 1 for the served 8
    queries and all 64, and at k 257; the searches' host ms, an ``auto``
    search's split into its parts (``pruned_split_ms``). With
    ``frontier_everywhere`` the base's ``exact_frontier`` must hold on
    every served row (as at splade_bert, where it always has); without
    it (xlmr, where the default budget of 64 candidates leaves a top-10
    doc out of a served row, in the reference as in the port) its share
    is printed and the rows where it fails are held as
    ``pruned_searches`` says."""
    from repro_torch.kernels import impact_score as k45
    from repro_torch.kernels import sparton as k1
    from repro_torch.launch.serve import SEED, grow_engine
    from repro_torch.retrieval.sparse_rep import stack_rows
    from repro_torch.runtime.serving import (BatchedEncoder, BatchPolicy,
                                             CorpusEngine,
                                             make_config_encoder)

    t_phase = time.perf_counter()
    cfg, res = served["cfg"], served["res"]
    encode = make_config_encoder(served["params"], cfg)
    batches = []

    def counted_encode(tokens, mask):
        batches.append(tokens.shape)
        return encode(tokens, mask)

    engine = CorpusEngine(
        BatchedEncoder(counted_encode,
                       policy=BatchPolicy(max_batch=PRUNED["batch"])),
        cfg.vocab_size, keep_forward=True, device="cuda")
    builder, k = engine.builder, SERVE["topk"]
    queries, served_all = res["queries"], stack_rows(res["served"])
    rng = np.random.default_rng(SEED)
    n = PRUNED["corpus"]
    reset_k1(k1)
    reset_k45(k45)
    with plain_guard(k1=(k1, "sparton_forward_plain"),
                     **k45_plains(k45)) as plain_on_cuda:
        t0 = time.perf_counter()
        grow_engine(engine, cfg.vocab_size, n, batch=PRUNED["batch"],
                    rng=rng)
        torch.cuda.synchronize()
        index_s = time.perf_counter() - t0
        grow_launches = k45_launches(k45)
        grown = engine.stats()
        dropped = rng.choice(n, size=int(PRUNED["remove_frac"] * n),
                             replace=False).tolist()
        require(engine.remove_docs(dropped) == len(dropped),
                "tombstoning removed fewer docs than asked")
        engine.flush()
        gone = set(dropped)
        in_place = {"stats": engine.stats(),
                    **pruned_searches(torch, engine, served_all, k, gone,
                                      "in place: ")}
        # no slot was renumbered since the growth's last compaction: a
        # dropped base doc's slot is its external id
        zeroed = builder._base_raw.doc_values[torch.as_tensor(
            [d for d in dropped if d < builder._base_n], device="cuda")]
        engine.flush(force_compact=True)
        added = engine.add_docs([rng.integers(1, cfg.vocab_size, size=16)
                                 .astype(np.int32)
                                 for _ in range(PRUNED["batch"])])
        engine.flush()
        out = pruned_searches(torch, engine, served_all, k, gone, "")
    base = builder._base
    # the comparisons with the plain version, outside the guard
    timing = {f"B{q.values.shape[0]}_k{c}": time_ceiling(
        torch, q, base, c, reps=20)
        for q, c in ((queries, out["candidates"] + 1),
                     (served_all, out["candidates"] + 1),
                     (queries, PRUNED["ceiling_ks"][-1]))}
    search_ms = {m: host_ms(torch, lambda: engine.search(
        queries, k, method=m)) for m in ("auto", "impact", "fused")}
    split_ms = pruned_split_ms(torch, queries, builder, k)
    st = engine.stats()
    require(not plain_on_cuda, f"plain versions ran on CUDA tensors: "
                               f"{sorted(set(plain_on_cuda))}")
    require(grow_launches["impact_topk"] == 0
            and grow_launches["impact_ceiling_topk"] == 0,
            f"growing the engine launched K4: {grow_launches}")
    require(k1.sparton_forward.launches == len(batches),
            f"K1 launched {k1.sparton_forward.launches} times for "
            f"{len(batches)} encode batches")
    require(in_place["stats"]["n_dead"] == len(dropped)
            and in_place["stats"]["n_compactions"] == grown["n_compactions"],
            f"the tombstones were not zeroed in place: {in_place['stats']}")
    require(st["base_docs"] == n - len(dropped)
            and st["delta_docs"] == PRUNED["batch"] and st["n_dead"] == 0,
            f"engine segments after the compaction and the last batch: {st}")
    launches = {"sparton_fwd": k1.sparton_forward.launches,
                "impact_ceiling_topk": sum(
                    row[m]["launches"]["impact_ceiling_topk"]
                    for row in (in_place, out) for m in row
                    if isinstance(row[m], dict) and "launches" in row[m])}
    k1_paths = k1_on_tma(k1, phase)
    forward_bytes = (base.doc_values.numel() * 4
                     + base.doc_indices.numel() * 4)
    emit(phase, config=cfg.name, launches=launches,
         k1_paths=k1_paths, encode_batches=len(batches), index_s=index_s,
         docs_grown=n, grown_stats=grown, removed=len(dropped),
         tombstoned_forward_rows_zeroed=bool((zeroed == 0).all()),
         added_after_compaction=len(added), stats=st,
         base_docs=base.n_docs, base_memory_bytes=base.memory_bytes(),
         forward_row_bytes=forward_bytes, max_postings=base.max_postings,
         posting_percentiles=list(base.posting_percentiles),
         in_place=in_place, searches=out, ceiling=timing,
         search_ms=search_ms, auto_split_ms=split_ms,
         seconds=time.perf_counter() - t_phase)
    require(bool((zeroed == 0).all()),
            "tombstoned docs' forward rows were not zeroed in place")
    frontier = in_place["exact_frontier"] + out["exact_frontier"]
    require(all(frontier) or not frontier_everywhere,
            f"exact_frontier false on {frontier.count(False)} of "
            f"{len(frontier)} rows at margin 0")
    return {"launches": launches, "timing": timing, "k1_paths": k1_paths,
            "engine": engine}


FRONTIER = {"cache_mb": 64.0, "deadline_ms": 5000.0, "max_queue": 256,
            "add": 64, "remove": 16, "tenants": 3, "tenant_corpus": 12288,
            "tenant_requests": 96, "contended": 256, "contended_ticks": 12}


def launch_counts(k1, k45):
    """K1's launches and ``k45_launches`` since their resets, with K4's
    window entry's apart (``impact_window_topk``)."""
    n = {"sparton_fwd": k1.sparton_forward.launches, **k45_launches(k45)}
    n["impact_window_topk"] = n["impact_topk"] - n["impact_index_topk"]
    return n


@contextlib.contextmanager
def per_search(k1, k45, log):
    """Record, for every ``CachedEngine.search`` in the block, the
    launches it made (``launch_counts`` after minus before) and its caches'
    stats after it, in ``log``."""
    from repro_torch.runtime.frontier import CachedEngine

    def wrap(name, fn):
        def wrapped(self, *a, **kw):
            before = launch_counts(k1, k45)
            out = fn(self, *a, **kw)
            after = launch_counts(k1, k45)
            log.append({"launches": {key: after[key] - before[key]
                                     for key in after},
                        "results": self.results.stats(),
                        "hot": self.hot.stats() if self.hot else None})
            return out
        return wrapped

    with patched(wrap, search=(CachedEngine, "search")):
        yield log


def same_bits(a, b):
    """Host ``(vals, ids)`` pairs equal bit for bit."""
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def time_hot_window(torch, queries, index, hot, k, *, reps):
    """K4's window entry on the hot windows of ``queries`` (``hot_windows``
    over ``index``) beside K4 in place on the same queries: both equal bit
    for bit (and to the window entry's plain version); device ms per call
    from CUDA-graph replays; CUDA-event times of the plain version and of
    the yardstick (``index_add_`` of the windows into (B, N), then
    ``torch.topk``); each entry's byte bound (the windows read once, or
    ``index_read_bytes``); the host ms of building the windows."""
    from repro_torch.kernels import impact_score as k45
    from repro_torch.retrieval.sparse_rep import query_columns
    from repro_torch.runtime.frontier.caches import hot_windows

    qi, qv = query_columns(queries, index.device)
    n, L = index.n_docs, index.max_postings
    w, docs = hot_windows(queries, index, hot=hot)
    B, W = w.shape
    kw = dict(n_docs=n, k=k, term_lanes=L)
    args = (qi, qv, index.term_starts, index.term_lens, index.postings_doc,
            index.postings_val)
    case, got = runs_vs_plain(
        torch, lambda: k45.fused_impact_topk(w, docs, **kw),
        lambda: k45.fused_impact_topk_plain(w, docs, **kw))
    in_place = k45.fused_impact_index_topk(*args, n_docs=n, k=k)
    equal_in_place = all(bool(torch.equal(a, b))
                         for a, b in zip(got, in_place))
    require(case["equal"] and case["bit_identical"] and equal_in_place,
            f"K4's window entry on the hot windows: {case}, equal to K4 in "
            f"place: {equal_in_place}")
    rows = torch.arange(B, device=index.device)[:, None] * n

    def library():
        flat = torch.zeros(B * n, device=index.device)
        flat.index_add_(0, (rows + docs.long()).view(-1), w.view(-1))
        return torch.topk(flat.view(B, n), k, dim=1)

    nbytes = B * W * 8 + B * k * 8
    in_place_bytes, postings, terms = index_read_bytes(torch, qi, qv, index,
                                                       k)
    row = {"shape": {"B": B, "Q": qi.shape[1], "L": L, "W": W,
                     "n_docs": n, "k": k}, **case,
           "equal_in_place": equal_in_place, "digest": digest(*got),
           "bytes": nbytes, "bound_ms": 1e3 * nbytes / peak_rate("bytes"),
           "bound_by": "bytes", "postings_read_in_place": postings,
           "terms_read": terms, "in_place_bytes": in_place_bytes,
           "in_place_bound_ms": 1e3 * in_place_bytes / peak_rate("bytes")}
    row["ms"], row["ms_range"] = graph_ms(
        torch, lambda: k45.fused_impact_topk(w, docs, **kw), reps)
    row["in_place_ms"], row["in_place_ms_range"] = graph_ms(
        torch, lambda: k45.fused_impact_index_topk(*args, n_docs=n, k=k),
        reps)
    for key, fn in (("plain_ms",
                     lambda: k45.fused_impact_topk_plain(w, docs, **kw)),
                    ("library_ms", library)):
        row[key], row[key + "_range"] = timed(torch, fn, reps)
    row["build_windows_host_ms"], _ = host_ms(
        torch, lambda: hot_windows(queries, index, hot=hot))
    return row


def frontier_caches(torch, encode, cfg, engine, k1, k45):
    """(a) and (c): the serve CLI's ``run`` on the pruned phase's engine as
    it stands (``corpus=0``), the loop continuous with a deadline and an
    admission bound, the 8 retrieved queries searched through its
    ``CachedEngine`` with ``fused`` twice; then a mutation and a third
    cached search; then ``auto``. Returns the run and its readings."""
    from repro_torch.launch.serve import SEED, run
    from repro_torch.runtime.serving import FailedResult, ShedResult

    k = SERVE["topk"]
    searches = []
    with per_search(k1, k45, searches):
        res = run(encode, cfg.vocab_size, corpus=0,
                  requests=SERVE["requests"], topk=k, method="auto",
                  index_batch=SERVE["index_batch"],
                  device=torch.device("cuda"), engine=engine,
                  continuous=True, deadline_ms=FRONTIER["deadline_ms"],
                  max_queue=FRONTIER["max_queue"],
                  cache_mb=FRONTIER["cache_mb"])
        cached, queries = res["cached"], res["queries"]
        off = engine.search(queries, k, method="fused")
        (v1, i1, s1), (v2, i2, s2) = res["passes"]
        hot_pass1 = dict(cached.hot.stats())
        gen0 = engine.builder.generation
        rng = np.random.default_rng(SEED + 25)
        added = cached.add_docs([rng.integers(1, cfg.vocab_size,
                                              size=16).astype(np.int32)
                                 for _ in range(FRONTIER["add"])])
        returned = [int(e) for e in dict.fromkeys(i1.ravel().tolist())]
        gone = returned[:FRONTIER["remove"]]
        require(cached.remove_docs(gone) == len(gone),
                f"removed fewer than {len(gone)} returned docs")
        cached.flush()
        mutated = cached.search(queries, k, method="fused")
        mutated_off = engine.search(queries, k, method="fused")
        auto = cached.search(queries, k)
        auto_off = engine.search(queries, k)
    loop = res["loop"]
    st = loop.stats()
    unserved = [r for r in res["outcomes"].values()
                if isinstance(r, (ShedResult, FailedResult))]
    require(not unserved and st["served"] == SERVE["requests"],
            f"frontier serve: {len(unserved)} requests not served under a "
            f"{FRONTIER['deadline_ms']} ms deadline: {st}")
    require(res["method"] == "fused", f"the cached search resolved to "
                                      f"{res['method']!r}, not 'fused'")
    first, second = searches[0], searches[1]
    require(first["launches"]["impact_window_topk"] == 1
            and first["hot"]["hits"] > 0,
            f"pass 1 launched K4's window entry "
            f"{first['launches']['impact_window_topk']} times with "
            f"{first['hot']['hits']} hot hits")
    require(not any(second["launches"].values())
            and second["results"]["hits"] == len(i1),
            f"pass 2 launched {second['launches']}, "
            f"{second['results']['hits']} result hits for {len(i1)} rows")
    for name, got in (("pass 1", (v1, i1)), ("pass 2", (v2, i2))):
        require(same_bits(got, off), f"{name} differs from cache-off fused")
    third = searches[2]
    require(engine.builder.generation > gen0
            and third["results"]["invalidations"] > 0
            and third["hot"]["invalidations"] > hot_pass1["invalidations"],
            f"after the mutation: generation {gen0} -> "
            f"{engine.builder.generation}, {third}")
    require(same_bits(mutated, mutated_off)
            and not set(gone) & set(mutated[1].ravel().tolist()),
            "after the mutation the cached search differs from cache-off "
            "or returns a removed id")
    require(same_bits(auto, auto_off)
            and searches[3]["launches"]["impact_window_topk"] == 0,
            f"auto through the cache (the scorer declines) differs from "
            f"cache-off auto, or launched the window entry: {searches[3]}")
    lat = loop.latencies()
    return res, {
        "loop": {key: st[key] for key in (
            "submitted", "served", "shed", "shed_admission", "shed_expired",
            "failed", "batch_cap", "continuous", "batch_occupancy")},
        "deadline_ms": FRONTIER["deadline_ms"],
        "max_queue": FRONTIER["max_queue"],
        "p50_latency_ms": 1e3 * float(np.percentile(lat, 50)),
        "p99_latency_ms": 1e3 * float(np.percentile(lat, 99)),
        "serve_s": res["serve_s"], "searches": searches,
        "pass_ms": [1e3 * s1, 1e3 * s2], "added": len(added),
        "removed": len(gone), "generation": [gen0,
                                             engine.builder.generation],
        "stats": cached.stats()}


def frontier_tenants(torch, encode, cfg, k1, k45):
    """(b): ``run_tenants`` with 3 tenants (weights 1, 2, 3; 4096 docs
    each), a shared result cache and hot caches, over the full-width
    encoder wrapped by ``inject_faults``: a persistent poison token in a
    ninth of t1's requests, a one-shot OOM on t2's last request (each a
    token past V, marked by ``mark``; a token that reaches the encoder is
    read as token 1). Then a contended window: ``contended`` requests a
    tenant, ``contended_ticks`` forced ticks, each tenant's batches and
    requests dispatched in it counted (stride scheduling shares requests
    by weight; t2's halved cap makes its batches smaller). Returns the
    readings."""
    from repro_torch.launch.serve import SEED, run_tenants
    from repro_torch.runtime.faults import inject_faults
    from repro_torch.runtime.serving import (FailedResult, Request,
                                             ShedResult)

    V = cfg.vocab_size
    poison, oom = V + 7, V + 11
    n_req = FRONTIER["tenant_requests"]

    def drill(tokens, mask):
        return encode(torch.where(tokens >= V, 1, tokens), mask)

    encode_f = inject_faults(drill, [
        {"on": {"token": poison}},
        {"on": {"token": oom}, "exc": "oom", "times": 1}])

    def mark(uid, name, tokens):
        if (name == "t1" and uid % 9 == 4) or uid == n_req - 1:
            tokens = tokens.copy()
            tokens[0] = poison if name == "t1" else oom
        return tokens

    poisoned = [u for u in range(n_req) if u % 3 == 1 and u % 9 == 4]
    require((n_req - 1) % 3 == 2, "the OOM request must be t2's")
    searches = []
    with per_search(k1, k45, searches):
        res = run_tenants(
            encode_f, V, tenants=FRONTIER["tenants"],
            corpus=FRONTIER["tenant_corpus"], requests=n_req,
            topk=SERVE["topk"], index_batch=SERVE["index_batch"],
            device=torch.device("cuda"), cache_mb=FRONTIER["cache_mb"],
            continuous=True, deadline_ms=FRONTIER["deadline_ms"],
            mark=mark)
    pool, names = res["pool"], res["names"]
    per = pool.stats()["tenants"]
    done = [uid for uid, (_, r) in res["outcomes"].items() if r is not None]
    require(sorted(done) == list(range(n_req))
            and not any(pool.tenant(n).loop.completed for n in names)
            and all(t["served"] + t["shed"] + t["failed"] == t["submitted"]
                    for t in per.values()),
            f"tenants: not every uid completed exactly once: {per}")
    failed = sorted(uid for uid, (_, r) in res["outcomes"].items()
                    if isinstance(r, FailedResult))
    require(failed == poisoned and per["t0"]["failed"] == 0
            and per["t2"]["failed"] == 0
            and not any(t["shed"] for t in per.values()),
            f"the poison failed {failed} (expected {poisoned}): {per}")
    half = SERVE["index_batch"] // 2
    require(per["t2"]["oom_faults"] == 1 and per["t2"]["batch_cap"] == half
            and per["t0"]["oom_faults"] == per["t1"]["oom_faults"] == 0,
            f"the OOM did not halve t2's cap to {half}: {per['t2']}")
    same = {}
    for name in names:
        off = pool.tenant(name).engine.search(res["queries"][name],
                                              SERVE["topk"], method="fused")
        same[name] = all(same_bits(p, off) for p in res["searches"][name])
    require(all(same.values()) and len(same) == FRONTIER["tenants"],
            f"cached tenant searches differ from their engines': {same}")
    window = sum(s["launches"]["impact_window_topk"] for s in searches)
    require(window >= FRONTIER["tenants"]
            and all(s["hot"]["hits"] > 0 for s in searches[::2]),
            f"tenant searches launched K4's window entry {window} times: "
            f"{searches}")

    # contention: every tenant backlogged, one batch a forced tick
    rng = np.random.default_rng(SEED + 26)
    uid = 10_000
    for _ in range(FRONTIER["contended"]):
        for name in names:
            pool.submit(name, Request(uid=uid, tokens=rng.integers(
                1, V, size=int(rng.integers(4, 24))).astype(np.int32)))
            uid += 1
    contended = [pool.tick(force=True)
                 for _ in range(FRONTIER["contended_ticks"])]
    pool.drain()
    left = [pool.take(names[(u - 10_000) % len(names)], u)
            for u in range(10_000, uid)]
    require(not any(isinstance(r, (ShedResult, FailedResult)) for r in left),
            "the contended window shed or failed requests")
    by_tenant = {n: sum(1 for t, _ in contended if t == n) for n in names}
    requests_by = {n: sum(b for t, b in contended if t == n) for n in names}
    stats = pool.stats()
    return {"per_tenant": {n: {key: per[n][key] for key in (
                "weight", "live_docs", "served", "shed", "failed", "faults",
                "oom_faults", "batch_cap", "memory_bytes", "cache")}
                for n in names},
            "poisoned": poisoned, "fault_log": len(encode_f.log),
            "dispatches": len(res["dispatches"]),
            "contended_dispatch": contended,
            "contended_batches_by_tenant": by_tenant,
            "contended_requests_by_tenant": requests_by,
            "vpass": {n: stats["tenants"][n]["vpass"] for n in names},
            "result_cache": stats["result_cache"],
            "memory_bytes": stats["memory_bytes"],
            "provision_s": res["provision_s"], "serve_s": res["serve_s"],
            "search_s": res["search_s"], "searches": searches,
            "cached_equals_engine": same}


def phase_serve_frontier(torch, served, pruned):
    """The serving frontier at full width: (a) the result and hot-posting
    caches over the pruned phase's engine through the serve CLI's ``run``
    (pass 1 all misses through K4's window entry, pass 2 all hits and no
    launch, both bit for bit cache-off ``fused``; then a mutation, and
    ``auto``, where the hot scorer declines); (c) the same run's loop,
    continuous with a deadline and an admission bound; (b) a tenant pool
    under injected faults (``frontier_tenants``); then the host ms of a
    cached hit, a cache-off ``fused`` search and a hot-window miss search,
    and K4's window entry at the hot windows' shape beside K4 in place
    (``time_hot_window``)."""
    from repro_torch.kernels import impact_score as k45
    from repro_torch.kernels import sparton as k1
    from repro_torch.runtime.faults import FaultError, inject_faults
    from repro_torch.runtime.frontier import CachedEngine, QueryResultCache
    from repro_torch.runtime.serving import make_config_encoder

    t_phase = time.perf_counter()
    cfg, engine = served["cfg"], pruned["engine"]
    encode = make_config_encoder(served["params"], cfg)
    k = SERVE["topk"]
    # the injector's token trigger on a tensor on the card
    probe = inject_faults(lambda t: t, [{"on": {"token": 5}}])
    require(probe(torch.tensor([[1, 2]], device="cuda")) is not None,
            "the injector fired on a CUDA tensor without its token")
    try:
        probe(torch.tensor([[1, 5]], device="cuda"))
        require(False, "the injector's token trigger missed a CUDA tensor")
    except FaultError:
        pass
    reset_k1(k1)
    reset_k45(k45)
    with plain_guard(k1=(k1, "sparton_forward_plain"),
                     **k45_plains(k45)) as plain_on_cuda:
        res, caches = frontier_caches(torch, encode, cfg, engine, k1, k45)
        cache_launches = launch_counts(k1, k45)
        tenants = frontier_tenants(torch, encode, cfg, k1, k45)
    launches = launch_counts(k1, k45)
    k1_paths = k1_on_tma(k1, "serve_frontier")
    require(not plain_on_cuda, f"plain versions ran on CUDA tensors: "
                               f"{sorted(set(plain_on_cuda))}")

    cached, queries = res["cached"], res["queries"]
    hot = cached.hot
    base = engine.builder._base
    search_ms = {
        "cached_hit": host_ms(torch, lambda: cached.search(
            queries, k, method="fused")),
        "cache_off_fused": host_ms(torch, lambda: engine.search(
            queries, k, method="fused")),
        "hot_window_miss": host_ms(torch, lambda: CachedEngine(
            engine, result_cache=QueryResultCache(1 << 20),
            hot_cache=hot).search(queries, k, method="fused")),
    }
    window = time_hot_window(torch, queries, base, hot, k, reps=20)
    emit("serve_frontier", config=cfg.name, launches=launches,
         cache_launches=cache_launches, k1_paths=k1_paths,
         caches=caches, tenants=tenants, search_ms=search_ms,
         hot_window=window, bytes_pinned=hot.bytes_pinned,
         pinned_terms=hot.pinned_terms, max_postings=base.max_postings,
         base_docs=base.n_docs, seconds=time.perf_counter() - t_phase)
    return {"launches": launches, "window": window, "k1_paths": k1_paths}


# --------------------------------------------------------------------------
# 6. train at full width
# --------------------------------------------------------------------------

GRAD_CHECK = (32, 128)   # pairs x tokens of the gradient check, remat off
# One step's gradients, per param ||g_x - g_plain|| / ||g_plain||, at bf16
# compute (the main path) and at f32 compute. The kernel head is held to
# GRAD_RATIO times the largest reading of three controls, runs of the
# plain head that change only the order of its f32 sums: the plain head
# again (index_add_ sums dH in another order each run), and with D
# reversed or permuted. Any such change moves every trunk gradient by the
# trunk's own rounding (about 7e-3 at bf16 in PERF.md's runs), so a limit
# set from one reading would be one run's noise; the controls measure it
# in the same run. Errors in the kernels below that size are the kernels
# phase's to find (BWD_TOL), and the f32 check's (controls about 1e-4).
LOSS_TOL = 1e-4
GRAD_RATIO = 2.0
TRAIN_STEPS = 5


def train_batches(torch, B, S, n, vocab):
    from repro_torch.data.synthetic import lsr_pair_batches

    it = lsr_pair_batches(batch=B, q_len=S, d_len=S, vocab=vocab)
    return [{k: torch.from_numpy(v).cuda() for k, v in next(it).items()}
            for _ in range(n)]


def register_split_heads(torch, D):
    """Head impls for the gradient check, each a forward and a backward
    from the kernels or their plain versions, recording the forward's
    i_max: "k1_plain_bwd" (K1, then the plain K2/K3), "plain_k23" (the
    plain forward, then K2 and K3) and the controls "plain_rev_d" and
    "plain_perm_d" (the plain head with D reversed or permuted). Returns
    ``{impl: [i_max, ...]}``."""
    from repro_torch.core import head_api
    from repro_torch.kernels import sparton as k1
    from repro_torch.kernels import sparton_bwd as kb

    class Split(torch.autograd.Function):
        @staticmethod
        def forward(ctx, H, E, b, mask, fwd, bwd, seen):
            y, i_max = fwd(H, E, b, mask)
            seen.append(i_max)
            ctx.save_for_backward(H, E, y, i_max)
            ctx.bwd = bwd
            return y.to(H.dtype)

        @staticmethod
        def backward(ctx, dy):
            H, E, y, i_max = ctx.saved_tensors
            dH, dE, db = ctx.bwd(dy.float().contiguous(), y, i_max, H, E)
            return dH.to(H.dtype), dE.to(E.dtype), db, None, None, None, None

    def plain_bwd(dy, y, i_max, H, E):
        return (kb.sparton_backward_dh_plain(dy, y, i_max, E, H.shape[1]),
                *kb.sparton_backward_de_plain(dy, y, i_max, H))

    perm = torch.randperm(D, generator=torch.Generator().manual_seed(5))
    perm = perm.cuda()
    fwds = {"k1": k1.sparton_forward, "plain": k1.sparton_forward_plain,
            "rev": lambda H, E, b, m: k1.sparton_forward_plain(
                H.flip(-1), E.flip(-1), b, m),
            "perm": lambda H, E, b, m: k1.sparton_forward_plain(
                H[..., perm], E[:, perm], b, m)}
    seen = {}
    for impl, fwd, bwd in (("k1_plain_bwd", "k1", plain_bwd),
                           ("plain_k23", "plain", kb.sparton_backward),
                           ("plain_rev_d", "rev", plain_bwd),
                           ("plain_perm_d", "perm", plain_bwd)):
        seen[impl] = []

        def head(H, E, b, mask, *, spec, fwd=fwds[fwd], bwd=bwd,
                 log=seen[impl]):
            require(spec.logit_softcap is None, "the split heads take no "
                                                "softcap")
            return Split.apply(H, E, b, mask, fwd, bwd, log)

        head_api.register_head_impl(impl, head)
    return seen


def grad_readings(torch, cfg, params, batch, seen):
    """One compute dtype of the gradient check: the losses, and per
    comparison the largest relative difference, its leaf and every
    leaf's."""
    import dataclasses

    from repro_torch.launch.steps import lsr_loss, value_and_grad
    from repro_torch.tree import tree_items

    losses, grads = {}, {}
    for log in seen.values():
        log.clear()
    for impl in ("kernel", "sparton", "sparton_again", *seen):
        loss, g = value_and_grad(lsr_loss(dataclasses.replace(
            cfg, head_impl=impl.replace("_again", ""))))(params, batch)
        losses[impl] = float(loss)
        grads[impl] = tree_items(g)
    require(all(np.isfinite(v) for v in losses.values()),
            f"non-finite loss {losses}")
    require(all(bool(torch.isfinite(t).all())
                for t in grads["kernel"].values()),
            "non-finite gradient with the kernel head")

    def rel(a, b="sparton"):
        per = {n: float((grads[a][n] - grads[b][n]).norm()
                        / grads[b][n].norm().clamp_min(1e-30))
               for n in grads[b]}
        worst = max(per, key=per.get)
        return {"max": per[worst], "leaf": worst, "per_leaf": per}

    def flips(a, b="plain_k23"):   # share of (b, v) whose i_max differs
        return [float((x != y).float().mean())
                for x, y in zip(seen[a], seen[b])]

    out = {"compute_dtype": cfg.compute_dtype, "loss": losses,
           "kernel_vs_plain": rel("kernel"),
           # the split: which half of the head the difference comes from
           "kernel_vs_k1_plain_bwd": rel("kernel", "k1_plain_bwd"),
           "k1_plain_bwd_vs_plain": rel("k1_plain_bwd"),
           "plain_k23_vs_plain": rel("plain_k23"),
           "controls": {"plain_again": rel("sparton_again"),
                        "rev_d": rel("plain_rev_d"),
                        "perm_d": rel("plain_perm_d")},
           "imax_flip_share": {"k1": flips("k1_plain_bwd"),
                               "rev_d": flips("plain_rev_d"),
                               "perm_d": flips("plain_perm_d")}}
    control = max(c["max"] for c in out["controls"].values())
    out["limit"] = GRAD_RATIO * control
    out["ratio"] = out["kernel_vs_plain"]["max"] / max(control, 1e-30)
    emit("train_grad_check", **out)
    l_k, l_p = losses["kernel"], losses["sparton"]
    require(abs(l_k - l_p) <= LOSS_TOL * abs(l_p),
            f"{cfg.compute_dtype}: kernel-head loss {l_k} vs plain head "
            f"{l_p}")
    for key in ("kernel_vs_plain", "kernel_vs_k1_plain_bwd"):
        require(out[key]["max"] <= out["limit"],
                f"{cfg.compute_dtype}: {key} reads {out[key]['max']} at "
                f"{out[key]['leaf']}, above {GRAD_RATIO} x the controls' "
                f"{control}")
    return out


def grad_check(torch, cfg, shape=GRAD_CHECK):
    """The gradient check at bf16 and at f32 compute (see GRAD_RATIO) on
    ``shape`` (pairs, tokens): per dtype, the kernel head's largest
    reading, its limit and its ratio to the controls."""
    import dataclasses

    from repro_torch.models.transformer import init_params

    seen = register_split_heads(torch, cfg.d_model)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    batch = train_batches(torch, *shape, 1, cfg.vocab_size)[0]
    summary = {}
    for dtype in ("bfloat16", "float32"):
        out = grad_readings(torch, dataclasses.replace(
            cfg, compute_dtype=dtype), params, batch, seen)
        summary[dtype] = {"kernel_vs_plain": out["kernel_vs_plain"]["max"],
                          "limit": out["limit"], "ratio": out["ratio"]}
        del out
        torch.cuda.empty_cache()
    return summary


def timed_train(torch, arch, cfg, shape, steps):
    """``steps`` timed steps of the train CLI's own loop (``make_runner``:
    its ``FaultTolerantRunner`` on its loader, a loss logged each step)
    for ``arch`` with ``cfg`` at ``shape``, from a seeded fresh state: the
    losses, each step's ms (an ``on_step`` hook synchronises and reads the
    clock, so a step spans the runner's whole iteration: the batch drawn
    and placed, the step, its bookkeeping), the runner's own step time
    (the step alone), the median of steps 2 on, pairs/s, the peak device
    memory, the head kernels' launches (each 2 a step call for the kernel
    head, none for another; the runner calls a step once more when it
    overran its deadline, and such retries are counted), K1's paths, the
    seconds of the checkpoint the
    runner writes at the end (into a temporary directory, removed after),
    and a torch.profiler trace of one more step."""
    import shutil
    import tempfile

    from repro_torch.kernels import sparton as k1
    from repro_torch.kernels import sparton_bwd as kb
    from repro_torch.launch.steps import build_lsr_train_step, init_state
    from repro_torch.launch.train import make_runner, pair_loader

    device = torch.device("cuda")
    step_s, mark = [], []

    def clock(step, state):
        torch.cuda.synchronize()
        now = time.perf_counter()
        step_s.append(now - mark[-1])
        mark.append(now)

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        with pair_loader(cfg, batch=shape.global_batch, seq_len=shape.seq_len,
                         device=device) as loader:
            # the runner alone holds the state, as in the CLI's run
            runner = make_runner(
                cfg, init_state(arch, torch.Generator(
                    device="cuda").manual_seed(0)),
                iter(loader), steps=steps, lr=2e-4, device=device,
                ckpt_dir=ckpt_dir, on_step=clock)
            step_fn, calls = runner.step_fn, []

            def counted_step(state, batch):   # a straggler's retry counts
                calls.append(1)
                return step_fn(state, batch)

            runner.step_fn = counted_step
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_k1(k1)
            kb.sparton_backward_dh.launches = 0
            kb.sparton_backward_de.launches = 0
            with plain_guard(k1=(k1, "sparton_forward_plain"),
                             k2=(kb, "sparton_backward_dh_plain"),
                             k3=(kb, "sparton_backward_de_plain")
                             ) as plain_on_cuda:
                mark.append(time.perf_counter())
                state = runner.run()
                final_ckpt_s = time.perf_counter() - mark[-1]
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    logged = [m for m in runner.metrics_log if "loss" in m]
    losses = [float(m["loss"]) for m in logged]
    launches = {"sparton_fwd": k1.sparton_forward.launches,
                "sparton_bwd_dh": kb.sparton_backward_dh.launches,
                "sparton_bwd_de": kb.sparton_backward_de.launches}
    impl = cfg.head_spec().impl
    want = 2 * len(calls) if impl == "kernel" else 0
    k1_paths = (k1_on_tma(k1, f"train {cfg.name} {shape.name}")
                if want else dict(k1.sparton_forward.path_launches))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    require(not runner.errors, f"{cfg.name} {shape.name}: train steps "
                               f"raised {runner.errors}")
    require(runner.skipped_steps == [],
            f"{cfg.name} {shape.name}: the runner skipped steps "
            f"{runner.skipped_steps}")
    require(len(losses) == len(step_s) == steps,
            f"{cfg.name} {shape.name}: {len(losses)} losses logged, "
            f"{len(step_s)} steps clocked, for {steps} steps")
    require(all(np.isfinite(losses)), f"non-finite train loss: {losses}")
    require(all(n == want for n in launches.values()),
            f"{cfg.name} {shape.name} ({impl} head): K1/K2/K3 launches "
            f"{launches} in {len(calls)} step calls, expected {want} each")
    require(not plain_on_cuda, f"plain versions ran on CUDA tensors: "
                               f"{sorted(set(plain_on_cuda))}")
    require(state["step"] == steps, "the step counter did not advance")
    later_ms = sorted(1e3 * t for t in step_s[1:])
    median_ms = later_ms[len(later_ms) // 2]
    out = {"config": cfg.name, "n_params": cfg.n_params, "head_impl": impl,
           "shape": {"name": shape.name, "pairs": shape.global_batch,
                     "seq_len": shape.seq_len, "remat": cfg.remat},
           "losses": losses, "step_ms": [1e3 * t for t in step_s],
           "runner_step_ms": [1e3 * m["step_time_s"] for m in logged],
           "median_step_ms": median_ms,
           "pairs_per_s": shape.global_batch / (median_ms / 1e3),
           "max_memory_allocated_gib": peak_gib, "launches": launches,
           "k1_paths": k1_paths, "final_ckpt_s": final_ckpt_s,
           "straggler_retries": len(calls) - steps}
    step = build_lsr_train_step(cfg, lr=2e-4)
    batch = train_batches(torch, shape.global_batch, shape.seq_len, 1,
                          cfg.vocab_size)[0]

    def one_step():
        t0 = time.perf_counter()
        step(state, batch)[1]["loss"].item()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    out["step_profile"] = traced(torch, one_step, median_ms, 1)
    del state, batch, runner
    torch.cuda.empty_cache()
    return out


def phase_train(torch):
    import dataclasses

    from repro_torch.configs.splade_bert import CONFIG, SHAPES

    # (a) one step's gradients, kernel head against the plain head
    checked = grad_check(torch, dataclasses.replace(CONFIG, remat=False))
    torch.cuda.empty_cache()

    # (b) timed steps of the train entry point at the paper's Table-3 point,
    # with its config (remat on, the head it picks by default)
    out = timed_train(torch, "splade_bert", CONFIG, SHAPES["table3_384"],
                      TRAIN_STEPS)
    emit("train", grad_check=checked, **out)
    return {"launches": out["launches"], "k1_paths": out["k1_paths"]}


# --------------------------------------------------------------------------
# 5. timing
# --------------------------------------------------------------------------

WINDOWS = 5   # timed windows per measurement: median reported, spread kept


def cuda_ms(torch, fn, reps, warmup=1):
    """Milliseconds per call: CUDA events around ``reps`` back-to-back
    calls, in WINDOWS windows after a warm-up. Returns the median window
    and stores every window in ``cuda_ms.windows``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(WINDOWS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    cuda_ms.windows = times
    return sorted(times)[WINDOWS // 2]


def timed(torch, fn, reps):
    """``cuda_ms`` with its spread: (median ms, [min ms, max ms])."""
    ms = cuda_ms(torch, fn, reps)
    return ms, [min(cuda_ms.windows), max(cuda_ms.windows)]


def peak_mb(torch, fn):
    """Device memory a call allocates at its peak, above what was live."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def profile_encode(torch, encode, cfg, *, batch=64, seq=16, n=5):
    """Index-shaped encode batches (trunk, head, sparsifier, copy of the
    reps to the host): wall ms per batch untraced, then a torch.profiler
    trace of the same batches for the device time per batch, the
    device's busy share of the untraced wall time, and the kernels that
    take the most device time."""
    from repro_torch.retrieval.sparse_rep import split_rows

    g = torch.Generator().manual_seed(11)
    toks = [torch.randint(1, cfg.vocab_size, (batch, seq), generator=g,
                          dtype=torch.int32) for _ in range(n + 1)]
    mask = torch.ones((batch, seq), dtype=torch.int32)

    def run():
        t0 = time.perf_counter()
        for t in toks[:n]:
            split_rows(encode(t, mask))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    split_rows(encode(toks[n], mask))             # warm-up
    wall_ms = run()
    return {"batch": [batch, seq], **traced(torch, run, wall_ms, n)}


def traced(torch, run, wall_ms, n):
    """``run()`` (n units of work, returning wall ms per unit) under
    torch.profiler: device ms per unit, the device's busy share of the
    untraced ``wall_ms``, kernels per unit, and the ten kernels that take
    the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_ms = run()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    if not kernels:
        return {"wall_ms": wall_ms, "traced_wall_ms": traced_ms,
                "device_ms": "not measured"}
    device_ms = sum(dev_us(e) for e in kernels) / 1e3 / n
    by_name = {}   # kernels whose names share the first 70 characters
    for e in kernels:
        by_name[e.key[:70]] = by_name.get(e.key[:70], 0) + dev_us(e) / 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return {"wall_ms": wall_ms, "traced_wall_ms": traced_ms,
            "device_ms": device_ms, "device_busy_share": device_ms / wall_ms,
            "kernels_per_unit": sum(e.count for e in kernels) / n,
            "top_device_ms": dict(top)}


def k1_bound_ms(B, S, D, V, itemsize, kept):
    """K1's bound from its cost function (``sparton.forward_cost``): the
    products of the ``kept`` (unmasked) positions only, since a masked
    logit is NEG_INF whatever H·E gives; every input read and every
    output written once."""
    from repro_torch.kernels.sparton import forward_cost

    flops, nbytes = forward_cost(B, S, D, V, itemsize, kept)
    t_ops = flops / peak_rate("bf16" if itemsize == 2 else "f32")
    t_bytes = nbytes / peak_rate("bytes")
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def k1_library(torch, H, E, b, mask, softcap=None):
    """The paper's PyTorch baseline: matmul, +b, the softcap if any, relu,
    log1p, mask, amax over S (in place where it can be, to fit the
    Table-1 logits)."""
    z = torch.matmul(H, E.t())
    z += b.to(z.dtype)
    if softcap is not None:
        z.div_(softcap).tanh_().mul_(softcap)
    z.relu_()
    z.log1p_()
    z *= mask[:, :, None].to(z.dtype)
    return z.amax(dim=1)


def in_turns(torch, fns, reps):
    """Time two functions in turns (a, b, b, a) with ``cuda_ms``: for
    each, the median ms of its windows and their [min, max]."""
    (a, fa), (b, fb) = fns.items()
    windows = {a: [], b: []}
    for key, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
        cuda_ms(torch, fn, reps)
        windows[key] += cuda_ms.windows
    return {key: (sorted(w)[len(w) // 2], [min(w), max(w)])
            for key, w in windows.items()}


def host_ms(torch, fn, n=30):
    """Median host ms of ``fn()`` followed by a synchronise (after one
    call that is not timed), and the [min, max] range."""
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    times.sort()
    return times[len(times) // 2], [times[0], times[-1]]


def host_us(torch, fn, n=20):
    """Host microseconds a call takes to enqueue (no synchronise inside
    the window): the wrapper, its allocations and, for "tma", encoding
    the tensor maps."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * seconds / n


def time_k1(torch, H, E, b, mask, *, reps, plain_reps):
    """K1 on the "tma" path beside the earlier WMMA design forced on the
    same inputs (``ms_wmma``; the two in turns), the plain version, the
    paper's PyTorch baseline (``library_ms``) and the bound."""
    from repro_torch.kernels import sparton as k1

    case = k1_compare(torch, H, E, b, mask, None)
    require(case["path"] == "tma" and case["imax_hard"] == 0
            and case["bit_identical"],
            f"K1 at {tuple(H.shape)}: {case}")
    B, S, D = H.shape
    V = E.shape[0]
    kept = int(mask.bool().sum())
    bound, by = k1_bound_ms(B, S, D, V, H.element_size(), kept)

    def tma():
        return k1.sparton_forward(H, E, b, mask)

    def wmma():
        return k1._launch(H, E, b, mask, None, _path="wmma")

    row = {"shape": [B, S, D, V], "dtype": str(H.dtype)[6:],
           "max_abs_err": case["max_abs_err"],
           "imax_mismatch": case["imax_mismatch"],
           "peak_mb": peak_mb(torch, tma),
           "library_peak_mb": peak_mb(torch, lambda: k1_library(
               torch, H, E, b, mask)),
           "kept_positions": kept, "bound_ms": bound, "bound_by": by}
    y_t, i_t = tma()
    y_w, i_w = wmma()
    row["wmma_vs_tma_max_abs_err"] = float((y_t - y_w).abs().max())
    del y_t, i_t, y_w, i_w
    for key, (ms, spread) in in_turns(
            torch, {"ms_wmma": wmma, "ms": tma}, reps).items():
        row[key], row[key + "_range"] = ms, spread
    for key, fn, reps_ in (
            ("plain_ms", lambda: k1.sparton_forward_plain(H, E, b, mask),
             plain_reps),
            ("library_ms", lambda: k1_library(torch, H, E, b, mask),
             plain_reps)):
        row[key], row[key + "_range"] = timed(torch, fn, reps_)
    row["bound_share"] = bound / row["ms"]
    row["host_us"] = host_us(torch, tma)
    row["host_us_wmma"] = host_us(torch, wmma)
    torch.cuda.empty_cache()
    return row


def head_library(torch, H, E, b, mask, softcap=None):
    """``k1_library`` written out of place, so that autograd can take its
    backward: the paper's PyTorch baseline as a training step runs it
    (with ``softcap``, ``cap * tanh(logits / cap)`` before the ReLU)."""
    z = torch.matmul(H, E.t()) + b.to(H.dtype)
    if softcap:
        z = softcap * torch.tanh(z / softcap)
    z = torch.log1p(torch.relu(z))
    return (z * mask[:, :, None].to(z.dtype)).amax(dim=1)


def head_kernel_fwd_bwd(torch, H, E, b, mask, dy, softcap=None):
    """K1 forward and K2 + K3 backward through ``ops.sparton_head``."""
    from repro_torch.kernels.ops import sparton_head

    Hk, Ek, bk = (t.detach().requires_grad_(True) for t in (H, E, b))
    y = sparton_head(Hk, Ek, bk, mask, logit_softcap=softcap)
    return torch.autograd.grad(y, (Hk, Ek, bk), dy.to(y.dtype))


def library_backward(torch, H, E, b, mask, dy, *, reps, softcap=None):
    """Backward-only times of the baseline (dH alone; dE with db) and the
    peak memory of its forward + backward. Where the batch does not fit
    the card, that is recorded and the batch halved until it fits."""
    oom = []
    B = H.shape[0]
    while B >= 1:
        fits = True
        try:
            Hl, El, bl = (t.detach().requires_grad_(True)
                          for t in (H[:B], E, b))
            m, g = mask[:B], dy[:B].to(H.dtype)
            peak = peak_mb(torch, lambda: torch.autograd.grad(
                head_library(torch, Hl, El, bl, m, softcap), (Hl, El, bl),
                g))
            y = head_library(torch, Hl, El, bl, m, softcap)
            dh = timed(torch, lambda: torch.autograd.grad(
                y, (Hl,), g, retain_graph=True), reps)
            de = timed(torch, lambda: torch.autograd.grad(
                y, (El, bl), g, retain_graph=True), reps)
            del y
        except torch.cuda.OutOfMemoryError:
            fits = False
        if fits:
            return {"batch": B, "oom_at_batch": oom, "dh_ms": dh[0],
                    "dh_ms_range": dh[1], "de_ms": de[0],
                    "de_ms_range": de[1], "peak_mb": peak}
        oom.append(B)
        torch.cuda.empty_cache()
        B //= 2
    raise SmokeFailure("the baseline head does not fit the card at batch 1")


def bwd_bound_ms(torch, kernel, H, E, dy, y, i_max, softcap=None):
    """The least time of K2 ("dh") or K3 ("de") for these inputs, and what
    sets it. Bytes: dy, y and i_max read once; the rows that a term with
    g != 0 reads (rows of E for K2, the distinct (b, i_max) rows of H for
    K3), once each; the output written once. Operations: one FMA (2 f32
    FLOP) per term with g != 0 and column, over the f32 peak. Terms with
    g == 0 are skipped by the kernels, so they are not counted."""
    from repro_torch.kernels._common import bwd_factor
    from repro_torch.kernels.sparton_bwd import de_cost, dh_cost

    B, S, D = H.shape
    V = E.shape[0]
    nz = bwd_factor(y, dy, softcap) != 0
    nnz = int(nz.sum())
    if kernel == "dh":
        flops, nbytes = dh_cost(B, S, D, V, E.element_size(), nnz,
                                int(nz.any(dim=0).sum()))
    else:
        rows = (torch.arange(B, device=H.device)[:, None] * S + i_max)[nz]
        flops, nbytes = de_cost(B, S, D, V, H.element_size(), nnz,
                                int(rows.unique().numel()))
    t_ops, t_bytes = flops / peak_rate("f32"), nbytes / peak_rate("bytes")
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", nnz / (B * V))


# K2/K3 timing rows: the train step's shape (384 x 256, padded as
# lsr_pair_batches pads it), Table-1 (320 x 512, unpadded), and two inputs
# at 384 x 256 that a trained model gives: "sparse" keeps each row's 256
# largest y (a trained SPLADE document rep keeps a few hundred terms) and
# "skewed" routes a random half of each row's terms to position 0 (a few
# positions collect many vocab rows). tools/ab_bwd.py times the same rows.
BWD_ROWS = ("train", "table1", "sparse", "skewed")
SPARSE_KEEP = 256


def bwd_timing_inputs(torch, E, b, name):
    """(H, mask, dy, y, i_max) of one K2/K3 timing row, from seed 12: bf16
    hidden states, (y, i_max) from K1 and a cotangent of scale 1e-2."""
    from repro_torch.configs.splade_bert import SHAPES
    from repro_torch.kernels.sparton import sparton_forward

    spec = SHAPES["table1" if name == "table1" else "table3_384"]
    B, S = spec.global_batch, spec.seq_len
    g = torch.Generator(device="cuda").manual_seed(12)
    H = torch.randn((B, S, E.shape[1]), generator=g,
                    device="cuda").to(torch.bfloat16)
    if name == "table1":
        mask = torch.ones((B, S), dtype=torch.int32, device="cuda")
    else:
        lens = torch.randint(int(0.3 * S), S + 1, (B, 1), generator=g,
                             device="cuda")
        mask = (torch.arange(S, device="cuda") < lens).int()
    y, i_max = sparton_forward(H, E, b, mask)
    dy = torch.randn(y.shape, generator=g, device="cuda") * 1e-2
    y, i_max = reroute(torch, y, i_max, S, name, g)
    return H, mask, dy, y, i_max


def reroute(torch, y, i_max, S, kind, g):
    """(y, i_max) of a routing case: "sparse" keeps each row's SPARSE_KEEP
    largest y (zeroing the rest, so g == 0 there), "skewed" routes a random
    half of each row's terms to position 0, "one_position" every term to
    position S // 2, "empty_buckets" every term to an even position (the
    odd ones get none); other kinds leave them as they are."""
    if kind == "sparse":
        top = y.topk(min(SPARSE_KEEP, y.shape[1]), dim=1).indices
        y = torch.zeros_like(y).scatter_(1, top, y.gather(1, top))
    elif kind == "skewed":
        half = torch.rand(y.shape, generator=g, device=y.device) < 0.5
        i_max = torch.where(half, 0, i_max).int()
    elif kind == "one_position":
        i_max = torch.full_like(i_max, S // 2)
    elif kind == "empty_buckets":
        i_max = i_max // 2 * 2
    return y, i_max


def sparse_product(torch, dy, y, i_max, S):
    """K2's and K3's function as one sparse matrix G (B * S, V): G[b * S +
    i_max[b, v], v] = g[b, v] where g != 0 (f32, coalesced), the
    yardstick ``torch.sparse.mm`` multiplies: dH = G @ E, dE = G^T @ H."""
    from repro_torch.kernels._common import bwd_factor

    g = bwd_factor(y, dy, None)
    nz = g != 0
    B, V = g.shape
    rows = (torch.arange(B, device=g.device)[:, None] * S + i_max)[nz]
    cols = torch.arange(V, device=g.device).expand(B, V)[nz]
    return torch.sparse_coo_tensor(torch.stack([rows, cols]), g[nz],
                                   (B * S, V)).coalesce()


def time_bwd(torch, H, E, b, mask, dy, y, i_max, *, reps, plain_reps,
             library, softcap=None):
    """K2 and K3 on one input: against their plain versions and a second
    launch, CUDA-event times of kernel and plain version, the bound, and a
    one-call yardstick: with ``library`` "head", the paper's baseline
    head's backward (dH alone; dE with db) and the head's forward +
    backward peak memory against the baseline's; with "sparse", the
    product of the routing as a sparse matrix (``torch.sparse.mm``), for
    inputs that no baseline head gives. ``softcap`` reaches the kernels,
    their plain versions, the bound and the baseline head."""
    from repro_torch.kernels import sparton_bwd as kb

    B, S, D = H.shape
    cap = softcap
    case = bwd_compare(torch, H, E, mask, dy, y, i_max, cap)
    require(case["within_tol"] and case["bit_identical"],
            f"K2/K3 at {(B, S, D)}: {case}")
    rows = {}
    for kernel, fn, plain, err in (
            ("dh", lambda: kb.sparton_backward_dh(dy, y, i_max, E, S,
                                                   softcap=cap),
             lambda: kb.sparton_backward_dh_plain(dy, y, i_max, E, S, cap),
             case["dH"]),
            ("de", lambda: kb.sparton_backward_de(dy, y, i_max, H,
                                                   softcap=cap),
             lambda: kb.sparton_backward_de_plain(dy, y, i_max, H, cap),
             max(case["dE"], case["db"]))):
        bound, by, share = bwd_bound_ms(torch, kernel, H, E, dy, y, i_max,
                                        cap)
        row = {"shape": [B, S, D, E.shape[0]], "dtype": str(H.dtype)[6:],
               "max_abs_err": err, "bit_identical": case["bit_identical"],
               "g_nonzero_share": share, "bound_ms": bound, "bound_by": by}
        row["ms"], row["ms_range"] = timed(torch, fn, reps)
        row["bound_share"] = bound / row["ms"]
        row["plain_ms"], row["plain_ms_range"] = timed(torch, plain,
                                                       plain_reps)
        rows[kernel] = row
    if library == "sparse":
        G = sparse_product(torch, dy, y, i_max, S)
        E32, H2 = E.float(), H.float().view(B * S, D)
        Gt = G.t().coalesce()
        for kernel, fn in (("dh", lambda: torch.sparse.mm(G, E32)),
                           ("de", lambda: torch.sparse.mm(Gt, H2))):
            ms, spread = timed(torch, fn, plain_reps)
            rows[kernel].update(library_ms=ms, library_ms_range=spread,
                                library="torch.sparse.mm")
        del G, Gt, E32, H2
        torch.cuda.empty_cache()
        return rows
    lib = library_backward(torch, H, E, b, mask, dy, reps=plain_reps,
                           softcap=cap)
    for kernel in ("dh", "de"):
        rows[kernel].update(library_ms=lib[f"{kernel}_ms"],
                            library_ms_range=lib[f"{kernel}_ms_range"],
                            library_batch=lib["batch"])
    rows["peak_mb_fwd_bwd"] = {
        "kernel": peak_mb(torch, lambda: head_kernel_fwd_bwd(
            torch, H, E, b, mask, dy, cap)),
        "library": lib["peak_mb"], "library_batch": lib["batch"],
        "library_oom_at_batch": lib["oom_at_batch"]}
    torch.cuda.empty_cache()
    return rows


def time_k6(torch, q, C, k, *, reps):
    """K6 at one shape: against its plain version, CUDA-event times of
    kernel, plain version and the yardstick (``torch.topk`` of the cuBLAS
    f32 product), the bound, and the peak memory of kernel and yardstick.
    The bound counts C and q read once, the (B, k) results written once,
    and the arithmetic the kernel does (the product skips no zeros): for
    B <= ``stream_rows()`` (8, stream_kernel) 2 * B * N * D f32 FMA FLOP at
    the f32 peak, else three TF32 products (3xTF32) of 2 * B * N * D FLOP
    each at the TF32 tensor-core peak. ``read_ms`` times ``C.sum()``: what
    one plain pass over the corpus takes here; ``ms_over_library`` is the
    kernel's time over the yardstick's."""
    from repro_torch.kernels.topk_score import (stream_rows, topk_score,
                                                topk_score_plain)

    B, D = q.shape
    N = C.shape[0]
    case = k6_compare(torch, q, C, k, False)
    require(case["within_tol"] and case["bit_identical"],
            f"K6 at {(B, N, D, k)}: {case}")
    t_ops = (2 * B * N * D / peak_rate("f32") if B <= stream_rows()
             else 3 * 2 * B * N * D / peak_rate("tf32"))
    t_bytes = (N * D * 4 + B * D * 4 + B * k * 8) / peak_rate("bytes")
    row = {"shape": {"B": B, "N": N, "D": D, "k": k}, **case,
           "bound_ms": 1e3 * max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "peak_mb": peak_mb(torch, lambda: topk_score(q, C, k=k)),
           "library_peak_mb": peak_mb(torch, lambda: torch.topk(
               q @ C.T, k, dim=1))}
    for key, fn in (("ms", lambda: topk_score(q, C, k=k)),
                    ("plain_ms", lambda: topk_score_plain(q, C, k=k)),
                    ("library_ms", lambda: torch.topk(q @ C.T, k, dim=1)),
                    ("read_ms", lambda: C.sum())):
        row[key], row[key + "_range"] = timed(torch, fn, reps)
    # printed, not gated: at B 64 the margin is within the library's own
    # spread between runs
    row["ms_over_library"] = row["ms"] / row["library_ms"]
    return row


def graph_ms(torch, fn, reps):
    """Device ms per call of ``fn``: ``reps`` back-to-back calls captured
    in a CUDA graph, replayed in WINDOWS windows timed with CUDA events, so
    that no host work sits between the launches (K4's and K5's calls take
    less device time than the host takes to enqueue them). Returns (median
    ms, [min ms, max ms])."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(WINDOWS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return sorted(times)[WINDOWS // 2], [min(times), max(times)]


def digest(*tensors) -> str:
    """SHA-256 of the tensors' bytes (16 hex digits)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def index_read_bytes(torch, qi, qv, index, k):
    """What a K4/K5 in-place call must move, each byte once: the query
    rep's (B, Q) ids and weights, the per-term columns of the distinct
    live query terms (K4: starts, lens; K5: starts, lens, lo, hi), their
    postings (K4 8 bytes each; K5 the delta bytes and the packed bytes
    the list spans) and the (B, k) results. Returns (bytes, postings,
    terms)."""
    B, Q = qi.shape
    terms = torch.unique(qi[qv > 0].long())
    starts = index.term_starts[terms].long()
    if index.term_lens.dtype == torch.uint16:
        lens = index.term_lens.view(torch.int16)[terms].long() & 0xFFFF
    else:
        lens = index.term_lens[terms].long()
    postings = int(lens.sum())
    nbytes = B * Q * 8 + B * k * 8
    if hasattr(index, "postings_doc"):
        nbytes += terms.numel() * 8 + postings * 8
    else:
        live = lens > 0
        packed = ((starts + lens - 1) >> 1) - (starts >> 1) + 1
        nbytes += (terms.numel() * (4 + index.term_lens.element_size() + 4)
                   + postings * index.deltas.element_size()
                   + int(packed[live].sum()))
    return nbytes, postings, terms.numel()


def time_impact(torch, queries, index, k, *, reps):
    """K4 (an ``InvertedIndex``) or K5 (a ``QuantizedIndex``) at one batch,
    both entries: each against its plain version and each other (equal
    digests of (vals, idx)); device ms of the in-place entry (``ms``) and
    of the window entry on the gathered windows (``window_ms``) from
    ``graph_ms``; the in-place entry's host enqueue time (``host_us``) and
    eager back-to-back CUDA-event time (``eager_ms``); CUDA-event times of
    the plain version and of the yardstick (``library_ms``: the window
    gather from the query and the index, then ``index_add_`` into (B, N)
    and ``torch.topk``: the same function from the same inputs; K5 also
    decodes); the bound over the byte rate from ``index_read_bytes``, the
    padded windows' bytes printed beside it."""
    from repro_torch.kernels import impact_score as k45
    from repro_torch.retrieval.sparse_rep import query_columns

    quant = not hasattr(index, "postings_doc")
    qi, qv = query_columns(queries, index.device)
    n, L = index.n_docs, index.max_postings
    B, Q = qi.shape
    if quant:
        args = (qi, qv, index.term_starts, index.term_lens, index.packed_vals,
                index.deltas, index.term_lo, index.term_hi)
        entry = k45.fused_quantized_index_topk
        plain = k45.fused_quantized_index_topk_plain
        wins = k45.quantized_index_windows(*args, L)
        window = lambda: k45.fused_quantized_topk(*wins, n_docs=n, k=k)
    else:
        args = (qi, qv, index.term_starts, index.term_lens,
                index.postings_doc, index.postings_val)
        entry = k45.fused_impact_index_topk
        plain = k45.fused_impact_index_topk_plain
        wins = k45.index_windows(*args, L)
        window = lambda: k45.fused_impact_topk(*wins, n_docs=n, k=k,
                                               term_lanes=L)
    kw = dict(n_docs=n, k=k)
    case, got = runs_vs_plain(torch, lambda: entry(*args, **kw),
                              lambda: plain(*args, **kw))
    win = window()
    rows = torch.arange(B, device=index.device)[:, None] * n

    def library():
        if quant:
            w, docs = k45.decode_quantized_windows(
                *k45.quantized_index_windows(*args, L))
        else:
            w, docs = k45.index_windows(*args, L)
        flat = torch.zeros(B * n, device=index.device)
        flat.index_add_(0, (rows + docs.view(B, -1)).view(-1), w.view(-1))
        return torch.topk(flat.view(B, n), k, dim=1)

    nbytes, postings, terms = index_read_bytes(torch, qi, qv, index, k)
    row = {"shape": {"B": B, "Q": Q, "L": L, "n_docs": n, "k": k}, **case,
           "equal_window": all(bool(torch.equal(a, b))
                               for a, b in zip(got, win)),
           "digest": digest(*got), "digest_window": digest(*win),
           "postings_read": postings, "terms_read": terms,
           "lanes_padded": B * Q * L, "bytes": nbytes,
           "padded_window_bytes": k45.fused_window_bytes(
               B, Q, L, "u4" if quant else "f32"),
           "bound_ms": 1e3 * nbytes / peak_rate("bytes"), "bound_by": "bytes"}
    require(case["equal"] and case["bit_identical"] and row["equal_window"],
            f"{'K5' if quant else 'K4'} at {row['shape']}: {row}")
    row["ms"], row["ms_range"] = graph_ms(torch, lambda: entry(*args, **kw),
                                          reps)
    row["window_ms"], row["window_ms_range"] = graph_ms(torch, window, reps)
    row["eager_ms"] = cuda_ms(torch, lambda: entry(*args, **kw), reps)
    row["host_us"] = host_us(torch, lambda: entry(*args, **kw))
    for key, fn in (("plain_ms", lambda: plain(*args, **kw)),
                    ("library_ms", library)):
        row[key], row[key + "_range"] = timed(torch, fn, reps)
    return row


def phase_timing(torch, served, served_dense, served_engine):
    from repro_torch.configs.splade_bert import SHAPES
    from repro_torch.models.transformer import forward_hidden, head_weights

    cfg, params, res = served["cfg"], served["params"], served["res"]
    g = torch.Generator(device="cuda").manual_seed(7)
    E, b = head_weights(params, cfg)
    E16 = E.to(torch.bfloat16)

    # K1 at the main path's shapes: real hidden states of an index batch
    # (64 docs x 16 tokens) and of a full query batch (16 queries of 4-24
    # tokens, padded to 32, as the loop serves them)
    rows = {}
    for name, (B, S, lo, hi) in (("index_batch", (64, 16, 16, 16)),
                                 ("query_batch", (16, 32, 4, 24))):
        toks = torch.randint(1, cfg.vocab_size, (B, S), generator=g,
                             device="cuda", dtype=torch.int32)
        lens = torch.randint(lo, hi + 1, (B, 1), generator=g, device="cuda")
        mask = (torch.arange(S, device="cuda") < lens).int()
        with torch.no_grad():
            H = forward_hidden(params, cfg, toks, mask)
        rows[name] = time_k1(torch, H, E16, b, mask, reps=20, plain_reps=5)
    # the paper's Table-1 point (B=320, S=512), random bf16 inputs
    t1 = SHAPES["table1"]
    H = (torch.randn((t1.global_batch, t1.seq_len, cfg.d_model),
                     generator=g, device="cuda")).to(torch.bfloat16)
    mask = torch.ones((t1.global_batch, t1.seq_len), dtype=torch.int32,
                      device="cuda")
    rows["table1"] = time_k1(torch, H, E16, b, mask, reps=3, plain_reps=1)
    del H
    torch.cuda.empty_cache()
    # the train step's shape (384 pairs' docs x 256 tokens, bf16, padded
    # as lsr_pair_batches pads them), where K1 runs twice a step
    t3 = SHAPES["table3_384"]
    g1 = torch.Generator(device="cuda").manual_seed(17)
    H = torch.randn((t3.global_batch, t3.seq_len, cfg.d_model), generator=g1,
                    device="cuda").to(torch.bfloat16)
    lens = torch.randint(int(0.3 * t3.seq_len), t3.seq_len + 1,
                         (t3.global_batch, 1), generator=g1, device="cuda")
    mask = (torch.arange(t3.seq_len, device="cuda") < lens).int()
    rows["train"] = time_k1(torch, H, E16, b, mask, reps=3, plain_reps=1)
    del H
    torch.cuda.empty_cache()

    # K4 at the serving shape: the served queries (8) and all 64 served
    # requests on the sparse phase's index
    from repro_torch.retrieval.sparse_rep import stack_rows

    queries, index = res["queries"], res["index"]
    k = res["idx"].shape[1]
    k4 = {f"B{q.values.shape[0]}": time_impact(torch, q, index, k, reps=20)
          for q in (queries, stack_rows(res["served"]))}
    # K6 at the dense serving shape: the served queries (8) and all 64
    # served requests against the (16384, 30522) f32 corpus
    dense = served_dense["res"]
    C = dense["index"]
    k6 = {f"B{q.shape[0]}": time_k6(torch, q, C, dense["idx"].shape[1],
                                    reps=10)
          for q in (dense["queries"].cuda(),
                    torch.from_numpy(np.stack(dense["served"])).cuda())}
    # K5 on the engine's quantized base: the served queries (8) and all 64
    # served requests
    base = served_engine["engine"].builder._base
    k5 = {f"B{q.values.shape[0]}": time_impact(torch, q, base, k, reps=20)
          for q in (queries, stack_rows(res["served"]))}
    from repro_torch.runtime.serving import make_config_encoder
    profile = profile_encode(torch, make_config_encoder(params, cfg), cfg)
    emit("timing", k1=rows, k4=k4, k5=k5, k6=k6, encode_profile=profile)

    # K2 and K3 on the four timing rows (BWD_ROWS)
    bwd = {}
    for name in BWD_ROWS:
        H, mask, dy, y, i_max = bwd_timing_inputs(torch, E16, b, name)
        bwd[name] = time_bwd(
            torch, H, E16, b, mask, dy, y, i_max,
            reps=3 if name == "table1" else 5, plain_reps=1,
            library="head" if name in ("train", "table1") else "sparse")
        del H, mask, dy, y, i_max
        torch.cuda.empty_cache()
    emit("timing_bwd", **bwd)
    return {"k1": rows["index_batch"], "k1_rows": rows, "bwd": bwd,
            "k4": k4, "k5": k5, "k6": k6}


# --------------------------------------------------------------------------
# 7. eval: the quality loop
# --------------------------------------------------------------------------

# (a) benchmarks/bench_quality.py's graded corpus at its FULL size: seed 3
# puts every planted grade in exact score order, so exact retrieval reads
# nDCG@10 = 1.0
EVAL_CORPUS = dict(vocab=1024, doc_nnz=32, q_nnz=26, graded=12, seed=3,
                   n_docs=512, n_queries=16)
EVAL_METHODS = (  # name, engine kwargs, search kwargs
    ("exact", {}, {}),
    ("pruned", {"keep_forward": True},          # K4's ceiling entry
     {"method": "pruned", "prune_margin": 0.0}),
    ("quantized", {"quantize": True}, {}),
    ("fused", {}, {"method": "fused"}),                       # K4 in place
    ("quantized_fused", {"quantize": True}, {"method": "fused"}),   # K5
    ("aggressive", {"keep_forward": True},      # lossy: printed, not gated
     {"method": "pruned", "prune_margin": 0.5}),
)
LOSSY_METHODS = ("aggressive",)
# benchmarks/check.py: a lossless method sits within QUALITY_TOL of exact
# on every metric; training beats its init by MIN_TRAIN_DELTA on MRR@10
# and nDCG@10
QUALITY_TOL = 1e-3
MIN_TRAIN_DELTA = 0.01
# (b) the train CLI at full width: evaluations at init and at step 10, each
# of 16384 held-out pairs (32768 rows encoded through K1, an index of 16384
# docs, where `exact`'s method="auto" resolves to K4 in place)
EVAL_CLI = ["--arch", "splade_bert", "--full", "--steps", "10", "--batch",
            "32", "--seq-len", "32", "--eval-every", "10", "--eval-queries",
            "16384"]
# posting lanes per chunk of queries in (b)'s impact search: its windows
# and scatter take about 40 bytes a lane
IMPACT_LANES = 2**27
# (c) bench_quality.py's trained_vs_init recipe (TRAIN), run to step 1000,
# where the schedule's warm-up ends, and evaluated at its FULL size's 250
# steps (printed) and at 1000 (gated): at 250 the JAX package's own run of
# the recipe does not gain MRR@10 on this tree (0.3545 -> 0.3368 on the CPU;
# 0.4815 at 1000)
EVAL_TRAIN = dict(batch=16, q_len=8, d_len=32, n_micro=2, lr=3e-4,
                  steps=1000, eval_at=(250, 1000), eval_queries=32)


@contextlib.contextmanager
def timed_calls(torch, **targets):
    """Wrap each callable ``name=(owner, attribute)`` so that every call is
    timed on the host clock between two synchronises. Yields ``{name:
    [(seconds, args, result), ...]}``; restores them on exit."""
    log = {name: [] for name in targets}

    def wrap(name, fn):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            log[name].append((time.perf_counter() - t0, a, out))
            return out
        return wrapped

    with patched(wrap, **targets):
        yield log


def head_and_impact_modules():
    from repro_torch.kernels import impact_score as k4
    from repro_torch.kernels import sparton as k1
    from repro_torch.kernels import sparton_bwd as kb

    return k1, kb, k4


def reset_launches():
    from repro_torch.kernels import topk_score as k6

    k1, kb, k4 = head_and_impact_modules()
    reset_k1(k1)
    kb.sparton_backward_dh.launches = 0
    kb.sparton_backward_de.launches = 0
    reset_k45(k4)
    k6.topk_score.launches = 0


def read_launches():
    """K1-K6's launches since ``reset_launches`` (K4's and K5's as
    ``k45_launches`` counts them)."""
    from repro_torch.kernels import topk_score as k6

    k1, kb, k4 = head_and_impact_modules()
    return {"sparton_fwd": k1.sparton_forward.launches,
            "sparton_bwd_dh": kb.sparton_backward_dh.launches,
            "sparton_bwd_de": kb.sparton_backward_de.launches,
            **k45_launches(k4), "topk_score": k6.topk_score.launches}


def eval_plains():
    """plain_guard targets: K1-K5's plain versions."""
    k1, kb, k4 = head_and_impact_modules()
    return {"k1": (k1, "sparton_forward_plain"),
            "k2": (kb, "sparton_backward_dh_plain"),
            "k3": (kb, "sparton_backward_de_plain"), **k45_plains(k4)}


def eval_graded(torch):
    """(a) The method matrix on the graded corpus: exact, pruned (K4's
    ceiling entry, margin 0), quantized, and the fused kernels reading the
    raw (K4) and the quantized (K5) index in place, each held to exact;
    and aggressive (pruned at margin 0.5), printed beside them."""
    from repro_torch.data.synthetic import lsr_impact_corpus
    from repro_torch.eval import MethodSpec, Qrels, evaluate_retrieval

    corpus = lsr_impact_corpus(**EVAL_CORPUS)
    qrels = Qrels.from_triples(corpus["qrels"])
    methods = [MethodSpec(name, engine=engine, search=search)
               for name, engine, search in EVAL_METHODS]
    reset_launches()
    with plain_guard(**eval_plains()) as plain_on_cuda:
        res = evaluate_retrieval(None, corpus, qrels, methods=methods,
                                 ks=(10,), device="cuda")
    launches = read_launches()
    require(not plain_on_cuda, f"eval graded: plain versions ran on CUDA "
                               f"tensors: {sorted(set(plain_on_cuda))}")
    exact = res["exact"]
    # the same gains summed for dcg and idcg: the ratio is 1.0 up to f32
    # rounding of the mean
    require(abs(exact["ndcg@10"] - 1.0) <= 1e-6
            and abs(exact["mrr@10"] - 1.0) <= 1e-6,
            f"eval graded: exact reads {exact}, not 1.0: the planted corpus "
            f"must be recovered exactly")
    gaps = {name: max(abs(m[key] - exact[key]) for key in exact)
            for name, m in res.items()}
    gated = {name: gap for name, gap in gaps.items()
             if name not in LOSSY_METHODS}
    require(max(gated.values()) <= QUALITY_TOL,
            f"eval graded: a method differs from exact by more than "
            f"{QUALITY_TOL}: {gated}")
    require(launches["impact_index_topk"] >= 1
            and launches["impact_ceiling_topk"] >= 2
            and launches["impact_q_index_topk"] >= 1
            and launches["impact_topk"] == launches["impact_index_topk"]
            and launches["impact_q_topk"] == launches["impact_q_index_topk"],
            f"eval graded: K4 and K5 must each read their index in place, "
            f"and pruned and aggressive run K4's ceiling entry: {launches}")
    return {"corpus": EVAL_CORPUS, "metrics": res, "max_gap_to_exact": gaps,
            "launches": launches}


def eval_full_width(torch):
    """(b) The train CLI at full width with --eval-every (EVAL_CLI), driven
    through its own ``run``: each evaluation's wall seconds split into
    encode, index build and search, rows encoded per second; then the final
    reps searched with ``impact`` (exact's ids must equal its ids but at
    near-ties) and ``quantized`` (K5 in place: printed, not gated)."""
    import io
    import shutil
    import tempfile

    from repro_torch.eval import MethodSpec, Qrels, compute_metrics, harness
    from repro_torch.launch import train as cli
    from repro_torch.retrieval.engine.builder import IndexBuilder
    from repro_torch.retrieval.index import build_inverted_index
    from repro_torch.retrieval.score import impact_scores
    from repro_torch.retrieval.sparse_rep import SparseRep, sparsify_topk
    from repro_torch.runtime.serving import make_config_encoder

    k1 = head_and_impact_modules()[0]
    # the CLI checkpoints at the end: into a directory of this run's own
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_eval_ckpt_")
    args = cli.parser().parse_args(EVAL_CLI + ["--ckpt-dir", ckpt_dir])
    n = args.eval_queries
    printed = io.StringIO()
    reset_launches()
    try:
        with plain_guard(**eval_plains()) as plain_on_cuda, \
                timed_calls(torch, evaluate=(cli, "evaluate_retrieval"),
                            encode=(harness, "encode_reps"),
                            build=(IndexBuilder, "flush"),
                            search=(IndexBuilder, "search")) as calls, \
                contextlib.redirect_stdout(printed):
            t0 = time.perf_counter()
            res = cli.run(args, torch.device("cuda"))
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    launches = read_launches()
    k1_paths = k1_on_tma(k1, "eval full width")
    lines = printed.getvalue().splitlines()
    require(not plain_on_cuda, f"eval: plain versions ran on CUDA tensors: "
                               f"{sorted(set(plain_on_cuda))}")
    for head in ("eval @ init: ", f"eval @ step {args.steps}: ",
                 "eval improvement over init: "):
        require(sum(line.startswith(head) for line in lines) == 1,
                f"eval: the CLI printed no single {head!r} line: {lines}")
    n_evals = 1 + len(res["evals"])
    chunks = 2 * -(-n // min(32, n))                 # docs and queries
    # K1 once a side of each step and once an encode chunk; K2 and K3 once
    # a side of each step
    want = {"sparton_fwd": 2 * args.steps + n_evals * chunks,
            "sparton_bwd_dh": 2 * args.steps,
            "sparton_bwd_de": 2 * args.steps,
            "impact_topk": n_evals, "impact_index_topk": n_evals,
            "impact_ceiling_topk": 0, "impact_q_topk": 0,
            "impact_q_index_topk": 0, "topk_score": 0}
    require(launches == want, f"eval: launches {launches}, expected {want} "
                              f"(exact resolving to K4 in place)")
    resolved = [a[0].resolved_method("auto") for _, a, _ in calls["search"]]
    require(resolved == ["fused"] * n_evals,
            f"eval: exact's auto resolved to {resolved}")

    # the device's share of an encode chunk's wall time, on the final params
    cfg = cli.config_from_args(args)
    encode = make_config_encoder(res["state"]["params"], cfg,
                                 spec=cfg.head_spec(rep_topk=None))
    encode_profile = profile_encode(
        torch, lambda t, m: sparsify_topk(encode(t, m), 64), cfg, batch=32,
        seq=args.seq_len, n=8)
    del encode

    evals = []
    for i, (step, metrics) in enumerate([(0, res["init"])] + res["evals"]):
        encode_s = calls["encode"][2 * i][0] + calls["encode"][2 * i + 1][0]
        evals.append({
            "step": step, "metrics": metrics,
            "wall_s": calls["evaluate"][i][0], "encode_s": encode_s,
            "index_build_s": calls["build"][i][0],
            "search_ms": 1e3 * calls["search"][i][0],
            "rows_per_s": 2 * n / encode_s})
    require(all(0.0 <= v <= 1.0 for e in evals for v in e["metrics"].values()),
            f"eval: metrics out of [0, 1]: {evals}")

    # the final evaluation's reps searched by two more methods: quantized
    # (K5 in place) at once, impact in chunks of queries, since its (B, Q,
    # max_postings) windows would not fit the card at B 16384
    doc_reps, q_reps = (calls["encode"][-2][2], calls["encode"][-1][2])
    exact_ids = torch.as_tensor(calls["search"][-1][2][1], device="cuda")
    qrels = Qrels.paired(n)
    vocab = cfg.vocab_size
    reset_launches()
    with plain_guard(**eval_plains()) as plain_on_cuda, \
            timed_calls(torch, build=(IndexBuilder, "flush"),
                        search=(IndexBuilder, "search")) as more:
        quantized = harness._search_one(
            MethodSpec("quantized", engine={"quantize": True}), doc_reps,
            q_reps, vocab, 10, np.arange(n), device="cuda")
        builder = IndexBuilder(vocab, device="cuda")
        builder.add(doc_reps)
        builder.flush()
        index = build_inverted_index(doc_reps, vocab, device="cuda")
        chunk = max(1, IMPACT_LANES // (q_reps.width * index.max_postings))
        impact, hard, differ = [], 0, 0
        for lo in range(0, n, chunk):
            rows = slice(lo, lo + chunk)
            q = SparseRep(q_reps.values[rows], q_reps.indices[rows],
                          q_reps.nnz[rows])
            ids = builder.search(q, 10, method="impact")[1]
            impact.append(ids)
            ids = torch.as_tensor(ids, device="cuda")
            require(bool((exact_ids[rows] >= 0).all() and (ids >= 0).all()),
                    "eval: a query's top 10 holds padding")
            h, d = ids_beyond_near_ties(torch, impact_scores(q, index),
                                        exact_ids[rows], ids)
            hard, differ = hard + h, differ + d
    more_launches = read_launches()
    require(not plain_on_cuda, f"eval: plain versions ran on CUDA tensors: "
                               f"{sorted(set(plain_on_cuda))}")
    require(more_launches["impact_q_index_topk"] == 1
            and more_launches["impact_q_topk"] == 1
            and more_launches["impact_topk"] == 0,
            f"eval: impact and quantized searches launched {more_launches}")
    require(hard == 0, f"eval: exact's ids differ from impact's at {hard} "
                       f"positions beyond near-ties")
    others = {
        "quantized": {"metrics": compute_metrics(
            quantized, qrels, ks=(10,), metrics=("mrr", "ndcg")),
            "index_build_s": more["build"][0][0],
            "search_ms": 1e3 * more["search"][0][0]},
        "impact": {"metrics": compute_metrics(
            np.concatenate(impact), qrels, ks=(10,), metrics=("mrr", "ndcg")),
            "index_build_s": more["build"][1][0],
            "search_ms": 1e3 * sum(t for t, _, _ in more["search"][1:]),
            "query_chunk": chunk, "max_postings": index.max_postings}}
    del index, builder, exact_ids, res
    torch.cuda.empty_cache()
    for key, n_more in more_launches.items():
        launches[key] += n_more
    return {"cli": " ".join(EVAL_CLI), "printed": lines, "run_s": run_s,
            "evaluations": evals, "encode_profile": encode_profile,
            "final_reps": others,
            "exact_ids_differ_from_impact": differ,
            "exact_ids_differ_beyond_near_ties": hard, "launches": launches,
            "k1_paths": k1_paths}


def trained_head(torch, impl):
    """(c) for one head: EVAL_TRAIN's steps of SMOKE splade_bert from the
    shared init on the shared data stream (both drawn on the CPU from
    seed 0: the same in any process), evaluated at init and at each of
    ``eval_at`` by the train CLI's ``evaluator`` on its held-out pairs;
    the last is gated."""
    import dataclasses

    from repro_torch.configs.splade_bert import SMOKE
    from repro_torch.data.synthetic import lsr_pair_batches
    from repro_torch.launch import train as cli
    from repro_torch.launch.steps import build_lsr_train_step, init_state
    from repro_torch.tree import tree_map

    t = EVAL_TRAIN
    init = init_state("splade_bert", torch.Generator().manual_seed(0),
                      smoke=True)
    it = lsr_pair_batches(batch=t["batch"], q_len=t["q_len"],
                          d_len=t["d_len"], vocab=SMOKE.vocab_size, seed=0)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in next(it).items()}
               for _ in range(t["steps"])]
    corpus, qrels = cli.held_out(SMOKE, t["eval_queries"], q_len=t["q_len"],
                                 d_len=t["d_len"])
    cfg = dataclasses.replace(SMOKE, head_impl=impl)
    evaluate = cli.evaluator(cfg, corpus, qrels, device=torch.device("cuda"))
    step = build_lsr_train_step(cfg, n_micro=t["n_micro"], lr=t["lr"])
    state = {"params": tree_map(lambda x: x.cuda(), init["params"]),
             "opt": tree_map(lambda x: x.cuda(), init["opt"]),
             "step": init["step"]}
    reset_launches()
    train_s = 0.0
    with plain_guard(**eval_plains()) as plain_on_cuda:
        evals = {0: evaluate(state)}
        losses = []
        for lo, hi in zip((0,) + t["eval_at"], t["eval_at"]):
            t0 = time.perf_counter()
            for b in batches[lo:hi]:
                state, m = step(state, b)
                losses.append(m["loss"])
            torch.cuda.synchronize()
            train_s += time.perf_counter() - t0
            evals[hi] = evaluate(state)
    losses = [float(x) for x in losses]
    launches = read_launches()
    require(not plain_on_cuda, f"eval {impl}: plain versions ran on CUDA "
                               f"tensors: {sorted(set(plain_on_cuda))}")
    n_side = 2 * t["n_micro"] * t["steps"]   # a head call a side
    want = ({"sparton_fwd": n_side + 2 * len(evals),
             "sparton_bwd_dh": n_side, "sparton_bwd_de": n_side}
            if impl == "kernel" else dict.fromkeys(
                ("sparton_fwd", "sparton_bwd_dh", "sparton_bwd_de"), 0))
    require({k: launches[k] for k in want} == want,
            f"eval {impl}: launches {launches}, expected {want}")
    delta = {at: {k: m[k] - evals[0][k] for k in m}
             for at, m in evals.items() if at}
    head = 25
    row = {"metrics": evals, "trained_minus_init": delta,
           "loss_first": losses[0], "loss_last": losses[-1],
           "loss_mean_first_25": float(np.mean(losses[:head])),
           "loss_mean_last_25": float(np.mean(losses[-head:])),
           "train_s": train_s, "steps_per_s": t["steps"] / train_s,
           "launches": launches}
    require(all(np.isfinite(losses)), f"eval {impl}: non-finite loss")
    require(np.mean(losses[-head:]) < np.mean(losses[:head]),
            f"eval {impl}: the loss did not fall: "
            f"{row['loss_mean_first_25']} -> {row['loss_mean_last_25']}")
    gated = delta[t["steps"]]
    require(all(gated[k] >= MIN_TRAIN_DELTA for k in ("mrr@10", "ndcg@10")),
            f"eval {impl}: trained minus init at step {t['steps']}: "
            f"{gated}, below {MIN_TRAIN_DELTA}")
    return row


def trained_head_worker(impl):
    """``trained_head`` in a spawned process, with the script's matmul
    settings."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return trained_head(torch, impl)


def start_trained_vs_init():
    """(c)'s two heads, each in a spawned process of its own, started now:
    their 1000 small steps are bound by the host (~12 steps/s), so they
    run beside (a), (b) and each other instead of after them (not beside
    the train phase: its card-bound steps would share the card with
    theirs). The pending rows, for ``eval_trained_vs_init``, which
    terminates the processes."""
    import atexit
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(2)
    atexit.register(pool.terminate)
    return {"pool": pool, **{impl: pool.apply_async(trained_head_worker,
                                                    (impl,))
                             for impl in ("kernel", "naive")}}


def eval_trained_vs_init(torch, pending=None):
    """(c) EVAL_TRAIN's steps of SMOKE splade_bert from one init state on
    one data stream, once with the kernel head and once with the paper's
    PyTorch baseline head (``naive``): ``trained_head`` of each, run in
    ``start_trained_vs_init``'s processes (``train_s`` is each head's
    seconds beside the other and the rest of the phase)."""
    pending = dict(pending or start_trained_vs_init())
    pool = pending.pop("pool")
    heads = {impl: r.get(900) for impl, r in pending.items()}
    # their CUDA contexts and cached blocks leave the card with them
    pool.terminate()
    pool.join()
    gap = {at: {k: v - heads["naive"]["metrics"][at][k] for k, v in m.items()}
           for at, m in heads["kernel"]["metrics"].items()}
    return {"recipe": EVAL_TRAIN, "heads": heads, "kernel_minus_naive": gap}


def phase_eval(torch):
    """The quality loop on the card: (a) the method matrix on the graded
    corpus, (b) the train CLI's --eval-every at full width, (c) trained
    against init with the kernel head and with the baseline head, in
    ``start_trained_vs_init``'s processes beside (a) and (b)."""
    pending = start_trained_vs_init()
    graded = eval_graded(torch)
    full = eval_full_width(torch)
    trained = eval_trained_vs_init(torch, pending)
    emit("eval", graded=graded, full_width=full, trained_vs_init=trained)
    return {"launches": {
        "graded": graded["launches"], "full_width": full["launches"],
        "trained_vs_init": trained["heads"]["kernel"]["launches"]},
        "k1_paths": full["k1_paths"]}


# --------------------------------------------------------------------------
# 8. splade_xlmr at full width
# --------------------------------------------------------------------------

# the gradient check's pairs x tokens at |V| 250002: the plain head's f32
# logits of a side, 8 x 128 x 250002, take 1 GB
XLMR_GRAD_CHECK = (8, 128)
XLMR_STEPS = {"train_420": 3, "train_16": 3}
# K1 against its plain version at V 250002 (977 tiles of 256 vocab
# columns, the last one 146 wide), with and without the softcap, a fully
# masked row: (B, S, softcap)
XLMR_K1 = [(2, 64, None), (3, 40, 5.0)]
# K2/K3 at D 768 and V 250002, where every row's routing list goes to
# device memory (V * 4 bytes past the routing pass's shared memory)
XLMR_BWD = (3, 256)


def xlmr_kernel_gates(torch, cfg):
    """K1, K2 and K3 at xlmr's D and V against their plain versions, each
    launched twice (the same bits)."""
    D, V = cfg.d_model, cfg.vocab_size
    cases = []
    for i, (B, S, softcap) in enumerate(XLMR_K1):
        H, E, b, mask = k1_inputs(torch, B, S, D, V, torch.bfloat16, 500 + i)
        mask[B - 1] = 0
        case = k1_compare(torch, H, E, b, mask, softcap)
        cases.append({"kernel": "K1", "shape": [B, S, D, V],
                      "softcap": softcap, **case,
                      "within_tol": case["imax_hard"] == 0})
        del H, E
    B, S = XLMR_BWD
    H, E, mask, dy, y, i_max = bwd_inputs(torch, B, S, D, V, torch.bfloat16,
                                          510, None)
    cases.append({"kernel": "K2/K3", "shape": [B, S, D, V],
                  **bwd_compare(torch, H, E, mask, dy, y, i_max, None)})
    del H, E, dy, y, i_max
    torch.cuda.empty_cache()
    bad = [c for c in cases if not (c["within_tol"] and c["bit_identical"])]
    require(not bad, f"xlmr: the head's kernels differ from their plain "
                     f"versions or between two launches: {bad[:2]}")
    return cases


def xlmr_timing(torch, E, b, shape):
    """K1, K2 and K3 at ``shape`` (train_420: 420 x 256, padded as
    lsr_pair_batches pads) on xlmr's head weights, random bf16 hidden
    states from seed 21 and a cotangent of scale 1e-2: K1 as ``time_k1``
    times it (its baseline's 53.8 GB of bf16 logits fit the card); K2 and
    K3 on the routing K1 gives at random init ("dense": nearly every g !=
    0) and on each row's SPARSE_KEEP largest y ("sparse"), beside
    torch.sparse.mm."""
    from repro_torch.kernels.sparton import sparton_forward

    B, S = shape.global_batch, shape.seq_len
    g = torch.Generator(device="cuda").manual_seed(21)
    H = torch.randn((B, S, E.shape[1]), generator=g,
                    device="cuda").to(torch.bfloat16)
    lens = torch.randint(int(0.3 * S), S + 1, (B, 1), generator=g,
                         device="cuda")
    mask = (torch.arange(S, device="cuda") < lens).int()
    k1_row = time_k1(torch, H, E, b, mask, reps=3, plain_reps=1)
    y, i_max = sparton_forward(H, E, b, mask)
    dy = torch.randn(y.shape, generator=g, device="cuda") * 1e-2
    bwd = {}
    for routing in ("dense", "sparse"):
        y_r, i_r = reroute(torch, y, i_max, S, routing, g)
        bwd[routing] = time_bwd(torch, H, E, b, mask, dy, y_r, i_r, reps=3,
                                plain_reps=1, library="sparse")
        del y_r, i_r
        torch.cuda.empty_cache()
    del H, y, i_max, dy
    torch.cuda.empty_cache()
    return {"k1": k1_row, "bwd": bwd}


def xlmr_serving(torch, served):
    """splade_xlmr's retrieval paths past the sparse serve, on the xlmr
    serve phase's weights and queries: the engine (``auto`` -> K5 in
    place), the pruned engine (``auto`` -> ``pruned``, K4's ceiling entry)
    and the dense serve (``auto`` -> K6), each phase's index, engine or
    corpus dropped before the next starts; only their V-dependent gates
    (``shared_gates`` off). K5 in place is timed on the engine's base (the
    served 8 queries and all 64, ``time_impact``), K6 at B 8 on the
    (16384, 250002) corpus (``time_k6``); K4's ceiling entry by the pruned
    phase itself."""
    from repro_torch.retrieval.sparse_rep import stack_rows

    t0 = time.perf_counter()
    res, k = served["res"], SERVE["topk"]
    engine = phase_serve_engine(torch, served, "xlmr_serve_engine",
                                shared_gates=False)
    rows = engine_rows(served, engine["engine"].builder)
    base = engine.pop("engine").builder._base
    k5 = {f"B{q.values.shape[0]}": time_impact(torch, q, base, k, reps=20)
          for q in (res["queries"], stack_rows(res["served"]))}
    del base
    torch.cuda.empty_cache()
    pruned = phase_serve_pruned(torch, served, "xlmr_serve_pruned",
                                frontier_everywhere=False)
    del pruned["engine"]
    torch.cuda.empty_cache()
    dense = phase_serve_dense(torch, served, "xlmr_serve_dense",
                              shared_gates=False)
    corpus = dense.pop("res")
    k6 = {"B8": time_k6(torch, corpus["queries"].cuda(), corpus["index"],
                        corpus["idx"].shape[1], reps=10)}
    del corpus
    torch.cuda.empty_cache()
    emit("xlmr_serve_timing", k5=k5, k6=k6,
         seconds=time.perf_counter() - t0)
    return {"engine": engine, "pruned": pruned, "dense": dense,
            "k5": k5, "k6": k6, "rows": rows}


def phase_xlmr(torch):
    """splade_xlmr (|V| 250002) at full width: the sparse serving path,
    then the engine, pruned and dense serving paths (``xlmr_serving``),
    the head's kernels at its V against their plain versions, the
    gradient check, the train CLI's loop at train_420 (kernel head) and
    at train_16 (kernel and baseline heads), then K1, K2 and K3 timed at
    train_420."""
    import dataclasses

    from repro_torch.configs.splade_xlmr import CONFIG, SHAPES
    from repro_torch.models.transformer import head_weights

    served = phase_serve(torch, CONFIG, "xlmr_serve")
    serving = xlmr_serving(torch, served)
    sharded_engine = phase_sharded_engine(torch, served, serving.pop("rows"),
                                          dimenet=True, recsys=True)
    E, b = head_weights(served["params"], served["cfg"])
    E16, b = E.to(torch.bfloat16), b.clone()
    serve_launches, serve_paths = served["launches"], served["k1_paths"]
    del served, E
    torch.cuda.empty_cache()

    gates = xlmr_kernel_gates(torch, CONFIG)
    checked = grad_check(torch, dataclasses.replace(CONFIG, remat=False),
                         XLMR_GRAD_CHECK)
    torch.cuda.empty_cache()
    emit("xlmr_kernels", cases=gates, grad_check=checked)

    trained = timed_train(torch, "splade_xlmr", CONFIG, SHAPES["train_420"],
                          XLMR_STEPS["train_420"])
    emit("xlmr_train", **trained)
    small = {impl: timed_train(
        torch, "splade_xlmr", dataclasses.replace(CONFIG, head_impl=impl),
        SHAPES["train_16"], XLMR_STEPS["train_16"])
        for impl in ("kernel", "naive")}
    emit("xlmr_train_16", **small)

    timing = xlmr_timing(torch, E16, b, SHAPES["train_420"])
    emit("xlmr_timing", **timing)
    del E16, b
    torch.cuda.empty_cache()
    return {"timing": timing, "serve_launches": serve_launches,
            "train_launches": trained["launches"], "serving": serving,
            "grad_check": checked, "sharded_engine": sharded_engine,
            "k1_paths": {"serve": serve_paths,
                         **{f"serve_{path}": serving[path]["k1_paths"]
                            for path in ("engine", "pruned", "dense")},
                         "train": trained["k1_paths"]}}


# --------------------------------------------------------------------------
# 9. checkpoint and resume at full width (splade_xlmr)
# --------------------------------------------------------------------------

# (a) the train CLI at xlmr's train_16 shape, checkpointing at steps 2 and
# 4 (and once more at the end, as the runner does); (c) the same flags
# with --resume to step 6
CKPT_CLI = ["--arch", "splade_xlmr", "--full", "--batch", "16", "--seq-len",
            "256", "--ckpt-every", "2"]
CKPT_STEPS = (4, 6)
KEEP_CKPTS = 3   # RunnerConfig's default keep_ckpts


@contextlib.contextmanager
def spans(**targets):
    """Wrap each callable ``name=(owner, attribute)`` so that every call's
    host-clock span (``time.monotonic``, no synchronise: the writer runs
    on a thread of its own) is recorded. Yields ``{name: [(t0, t1),
    ...]}``; restores them on exit."""
    log = {name: [] for name in targets}

    def wrap(name, fn):
        def wrapped(*a, **kw):
            t0 = time.monotonic()
            out = fn(*a, **kw)
            log[name].append((t0, time.monotonic()))
            return out
        return wrapped

    with patched(wrap, **targets):
        yield log


def timed_steps(cli, log):
    """Patch the CLI's step builder so that each step call's host span,
    up to the device finishing it, lands in ``log``. Returns the undo."""
    from repro_torch.runtime.fault_tolerance import block_until_ready

    build = cli.build_lsr_train_step

    def build_timed(cfg, **kw):
        step = build(cfg, **kw)

        def timed_step(state, batch):
            t0 = time.monotonic()
            out = step(state, batch)
            block_until_ready(out[0])
            log.append((t0, time.monotonic()))
            return out
        return timed_step

    cli.build_lsr_train_step = build_timed
    return lambda: setattr(cli, "build_lsr_train_step", build)


def tensor_leaves(state):
    from repro_torch.tree import tree_leaves

    return tree_leaves({"params": state["params"], "opt": state["opt"]})


def max_abs_diff(torch, a, b):
    return max(float((x - y).abs().max()) for x, y in
               zip(tensor_leaves(a), tensor_leaves(b), strict=True))


def ckpt_cli_run(torch, cli, argv, where):
    """The train CLI's ``run`` on ``argv``, the kernels counted from 0 and
    no plain version allowed on a CUDA tensor: the result, its printed
    lines, the launches and K1's paths."""
    import io

    k1 = head_and_impact_modules()[0]
    printed = io.StringIO()
    reset_launches()
    with plain_guard(**eval_plains()) as plain_on_cuda, \
            contextlib.redirect_stdout(printed):
        res = cli.run(cli.parser().parse_args(argv), torch.device("cuda"))
    torch.cuda.synchronize()
    launches = read_launches()
    require(not plain_on_cuda, f"ckpt {where}: plain versions ran on CUDA "
                               f"tensors: {sorted(set(plain_on_cuda))}")
    require(res["skipped"] == [],
            f"ckpt {where}: the runner skipped steps {res['skipped']}")
    return res, printed.getvalue().splitlines(), launches, k1_on_tma(
        k1, f"ckpt {where}")


def phase_ckpt(torch):
    """Checkpoint and resume splade_xlmr at full width through the train
    CLI's own ``run``: (a) 4 steps at 16 x 256, checkpoints at steps 2
    and 4; (b) the checkpoint reloaded onto the card, bit for bit the
    state; (c) ``--resume`` to step 6; (d) against the same 2 steps run
    on in memory; (e) no step skipped; (f) the save, write and load
    seconds, the bytes on disk and the step ms with and without a write
    in flight; (g) the example's 200 SMOKE steps."""
    import io
    import shutil
    import tempfile

    from repro_torch.checkpoint import store
    from repro_torch.examples import train_splade
    from repro_torch.launch import train as cli
    from repro_torch.runtime import fault_tolerance as ft

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        first, resumed = CKPT_STEPS
        argv = CKPT_CLI + ["--ckpt-dir", ckpt_dir]
        cfg = cli.config_from_args(cli.parser().parse_args(argv))
        # f32 params, mu and nu: the kept checkpoints and one being written
        need = (KEEP_CKPTS + 1) * 12 * cfg.n_params
        free = shutil.disk_usage(ckpt_dir).free
        require(free >= need, f"ckpt: {free} bytes free where {ckpt_dir} "
                              f"lies, the checkpoints need {need}")

        # (a) and (c), each call's span logged
        step_spans = []
        undo = timed_steps(cli, step_spans)
        try:
            with spans(d2h=(store, "host_state"),
                       write=(store, "save_checkpoint"),
                       load=(ft, "load_checkpoint")) as io_spans:
                t0 = time.perf_counter()
                res_a, printed_a, launches_a, paths_a = ckpt_cli_run(
                    torch, cli, argv + ["--steps", str(first)], "first run")
                run_a_s = time.perf_counter() - t0
                steps_a = len(step_spans)
                on_disk = sorted(p.name for p in Path(ckpt_dir).iterdir())
                ckpt_bytes = sum(f.stat().st_size for f in (
                    Path(ckpt_dir) / f"step_{first:09d}").iterdir())

                # (b) the checkpoint of step 4, loaded onto the card
                s4 = res_a["state"]
                state_bytes = sum(x.numel() * x.element_size()
                                  for x in tensor_leaves(s4))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loaded, step = store.load_checkpoint(ckpt_dir, s4)
                torch.cuda.synchronize()
                load_s = time.perf_counter() - t0
                require(step == first and loaded["step"] == first,
                        f"ckpt: the latest checkpoint is step {step}")
                require(all(x.is_cuda for x in tensor_leaves(loaded)),
                        "ckpt: a loaded leaf is not on the card")
                bit_identical = all(torch.equal(x, y) for x, y in zip(
                    tensor_leaves(loaded), tensor_leaves(s4), strict=True))
                require(bit_identical, "ckpt: the loaded state differs from "
                                       "the one saved")
                del loaded
                torch.cuda.empty_cache()

                t0 = time.perf_counter()
                res_c, printed_c, launches_c, paths_c = ckpt_cli_run(
                    torch, cli, argv + ["--steps", str(resumed), "--resume"],
                    "resumed run")
                run_c_s = time.perf_counter() - t0
        finally:
            undo()
        require(on_disk == [f"step_{s:09d}" for s in (2, first)],
                f"ckpt: after the first run {ckpt_dir} holds {on_disk}")
        require(f"resumed from step {first}" in printed_c,
                f"ckpt: the resumed run printed {printed_c}")
        require(res_c["start_step"] == first
                and res_c["state"]["step"] == resumed
                and len(res_c["losses"]) == resumed - first,
                f"ckpt: resumed at {res_c['start_step']}, ended at step "
                f"{res_c['state']['step']}")
        # K1-K3 twice a step call; the runner calls a step once more when
        # it overran its deadline (its straggler retry, at most one a
        # step), so the calls are counted from the spans each run logged
        calls = {first: steps_a, resumed: len(step_spans) - steps_a}
        retries = {first: calls[first] - first,
                   resumed: calls[resumed] - (resumed - first)}
        for n_steps, launches in ((first, launches_a),
                                  (resumed, launches_c)):
            got = {k: launches[k] for k in ("sparton_fwd", "sparton_bwd_dh",
                                            "sparton_bwd_de")}
            ran = calls[n_steps] - retries[n_steps]
            require(0 <= retries[n_steps] <= ran
                    and all(v == 2 * calls[n_steps] for v in got.values()),
                    f"ckpt: K1-K3 launches {got} in {calls[n_steps]} step "
                    f"calls ({retries[n_steps]} retried), expected "
                    f"{2 * calls[n_steps]} each")

        # (d) the same two steps on in memory from S4 through the CLI's
        # loop: a fresh shard-0 stream, as the resumed run's; its runner
        # checkpoints only at the end, into a directory of its own
        def continue_s4():
            device = torch.device("cuda")
            control_dir = tempfile.mkdtemp(dir=ckpt_dir, prefix="control_")
            with cli.pair_loader(cfg, batch=16, seq_len=256,
                                 device=device) as loader:
                runner = cli.make_runner(
                    cfg, s4, iter(loader), steps=resumed - first,
                    lr=cli.parser().get_default("lr"), device=device,
                    ckpt_dir=control_dir)
                state = runner.run()
            shutil.rmtree(control_dir)
            require(not runner.errors and runner.skipped_steps == [],
                    f"ckpt: the in-memory control's steps raised "
                    f"{runner.errors}, skipped {runner.skipped_steps}")
            return state, [float(m["loss"]) for m in runner.metrics_log]

        with plain_guard(**eval_plains()) as plain_on_cuda:
            s6_mem, losses_mem = continue_s4()
            s6 = res_c["state"]
            diff = max_abs_diff(torch, s6, s6_mem)
            control = None
            if diff:   # the trunk is not run-to-run reproducible: measure
                s6_again, _ = continue_s4()
                control = max_abs_diff(torch, s6_again, s6_mem)
                del s6_again
        require(not plain_on_cuda, f"ckpt: plain versions ran on CUDA "
                                   f"tensors: {sorted(set(plain_on_cuda))}")
        gate = "bit_identical" if diff == 0 else "within_control"
        require(s6["step"] == s6_mem["step"] == resumed
                and (diff == 0 or diff <= control),
                f"ckpt: the resumed state differs from the in-memory "
                f"continuation by {diff} (control {control})")
        losses_c = res_c["losses"]
        del s4, s6, s6_mem, res_a, res_c
        torch.cuda.empty_cache()

        # (f) the step spans against the writes in flight
        writes = io_spans["write"]

        def overlaps(span):
            return any(w0 < span[1] and span[0] < w1 for w0, w1 in writes)

        step_ms = [{"run": "first" if i < steps_a else "resumed",
                    "ms": 1e3 * (t1 - t0),
                    "write_in_flight": overlaps((t0, t1))}
                   for i, (t0, t1) in enumerate(step_spans)]
        later = [s for i, s in enumerate(step_ms) if i not in (0, steps_a)]
        busy = sorted(s["ms"] for s in later if s["write_in_flight"])
        idle = sorted(s["ms"] for s in later if not s["write_in_flight"])

        # (g) the example's SMOKE run on the card
        reset_launches()
        printed = io.StringIO()
        with plain_guard(**eval_plains()) as plain_on_cuda, \
                contextlib.redirect_stdout(printed):
            t0 = time.perf_counter()
            example = train_splade.run(train_splade.parser().parse_args([]),
                                       torch.device("cuda"))
            example_s = time.perf_counter() - t0
        launches_g = read_launches()
        require(not plain_on_cuda, f"ckpt example: plain versions ran on "
                                   f"CUDA tensors: "
                                   f"{sorted(set(plain_on_cuda))}")
        require(example["skipped"] == [],
                f"ckpt example: skipped steps {example['skipped']}")
        n_side = 2 * 2 * 200      # 2 micro-batches x 2 sides a step
        require(launches_g["sparton_bwd_dh"] == n_side
                and launches_g["sparton_bwd_de"] == n_side
                and launches_g["sparton_fwd"] == n_side + 2,
                f"ckpt example: launches {launches_g}")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    def secs(log):
        return [t1 - t0 for t0, t1 in log]

    out = {
        "cli": " ".join(CKPT_CLI), "steps": list(CKPT_STEPS),
        "printed": {"first": printed_a, "resumed": printed_c},
        "run_s": {"first": run_a_s, "resumed": run_c_s},
        "files_after_first_run": on_disk, "ckpt_bytes": ckpt_bytes,
        "state_bytes": state_bytes, "disk_free_bytes_before": free,
        "d2h_s": secs(io_spans["d2h"]), "write_s": secs(writes),
        "resume_load_s": secs(io_spans["load"]), "load_s": load_s,
        "load_bit_identical": bit_identical,
        "resumed_vs_in_memory": {"gate": gate, "max_abs_diff": diff,
                                 "control_max_abs_diff": control,
                                 "losses_resumed": losses_c,
                                 "losses_in_memory": losses_mem},
        "step_ms": step_ms,
        "straggler_retries": {"first": retries[first],
                              "resumed": retries[resumed]},
        "median_step_ms": {"write_in_flight": busy[len(busy) // 2]
                           if busy else None,
                           "no_write": idle[len(idle) // 2] if idle else None},
        "launches": {"first": launches_a, "resumed": launches_c,
                     "example": launches_g},
        "k1_paths": {"first": paths_a, "resumed": paths_c},
        "example": {**example, "s": example_s,
                    "printed": printed.getvalue().splitlines()}}
    emit("ckpt", **out)
    return {"launches": out["launches"],
            "k1_paths": {"ckpt_first": paths_a, "ckpt_resumed": paths_c}}


# --------------------------------------------------------------------------
# 10. the paper path's examples, and streaming_topk at full width
# --------------------------------------------------------------------------

# the four flag sets of repro_torch.examples.serve_retrieval's docstring
EXAMPLE_SERVE = {
    "frozen": [],
    "engine_quantize": ["--engine", "--quantize"],
    "engine_prune": ["--engine", "--prune-margin", "0.0"],
    "engine_cache": ["--engine", "--cache-mb", "4"],
}
# the JAX package's retrieval_cand shape (build_retrieval_step): 1,000,000
# candidates padded to 1,000,448 (configs/base.py:254-255,
# configs/specs.py:206-211), embed_dim 128 (DLRM MLPerf,
# configs/dlrm_mlperf.py:24), k 100, at batches 1, 8 (K6's f32 FMA path)
# and 64 (its 3xTF32 wgmma path)
STREAMING = {"N": 1000448, "D": 128, "k": 100, "B": (1, 8, 64),
             "tile": 65536, "reps": 20}


def phase_example_serve(torch):
    """``repro_torch.examples.serve_retrieval.run`` on the card, once for
    each flag set of its docstring, every plain version guarded: its own
    checks (exact ids, or on the card ids that differ only at near ties,
    printed), K1 on every encode ("tma"), K6 once (part 3b), K4's ceiling
    entry under ``--prune-margin``; K4 and K5 are counted, not required
    (``auto`` takes the plain ``impact``/``quantized`` methods at 480
    docs, and the hot scorer declines them)."""
    import io

    from repro_torch.examples import serve_retrieval
    from repro_torch.kernels import topk_score as k6

    k1, _, _ = head_and_impact_modules()
    out = {}
    for name, flags in EXAMPLE_SERVE.items():
        reset_launches()
        printed = io.StringIO()
        with plain_guard(**eval_plains(), k6=(k6, "topk_score_plain")
                         ) as plain_on_cuda, \
                contextlib.redirect_stdout(printed):
            t0 = time.perf_counter()
            res = serve_retrieval.run(
                serve_retrieval.parser().parse_args(flags),
                torch.device("cuda"))
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        launches = read_launches()
        k1_paths = k1_on_tma(k1, f"example_serve {name}")
        require(not plain_on_cuda, f"example_serve {name}: plain versions "
                                   f"ran on CUDA tensors: "
                                   f"{sorted(set(plain_on_cuda))}")
        require(launches["topk_score"] == 1,
                f"example_serve {name}: K6 launched "
                f"{launches['topk_score']} times, expected 1 (part 3b)")
        if "--prune-margin" in flags:
            require(launches["impact_ceiling_topk"] >= 1,
                    f"example_serve {name}: K4's ceiling entry never "
                    f"launched under --prune-margin")
        st = res["serving"]
        row = {"flags": " ".join(flags), "wall_s": wall_s,
               "launches": launches, "k1_paths": k1_paths,
               "self_retrieval": res["hits"],
               "served": st["served"], "shed": st["shed"],
               "failed": st["failed"],
               "exact_ids": res["exact_ids"],
               "exact_without_near_tie_rule": all(res["exact_ids"].values()),
               "printed": printed.getvalue().splitlines()}
        if "engine" in res:
            row["engine_stats"] = res["engine"]["stats"]
            if "cache_stats" in res["engine"]:
                cs = res["engine"]["cache_stats"]
                row["cache"] = {"results": cs["results"],
                                "hot": cs["hot"]}
        emit("example_serve", name=name, **row)
        out[name] = row
    return {"launches": {name: row["launches"] for name, row in out.items()},
            "k1_paths": {name: row["k1_paths"] for name, row in out.items()}}


def phase_example_quickstart(torch):
    """``repro_torch.examples.quickstart.run`` on the card (f32 inputs: K1's
    "f32" path, for the kernel head and ``sparton_forward_with_indices``),
    at least one K1 launch; then ``sparton_forward_with_indices`` on its
    inputs against K1 launched directly (the same bits) and K1 against its
    plain version by ``k1_compare``'s rule."""
    import io

    from repro_torch.core.lm_head import sparton_forward_with_indices
    from repro_torch.examples import quickstart

    k1, _, _ = head_and_impact_modules()
    reset_launches()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        t0 = time.perf_counter()
        res = quickstart.run(quickstart.parser().parse_args([]),
                             torch.device("cuda"))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    launches = read_launches()
    paths = dict(k1.sparton_forward.path_launches)
    require(launches["sparton_fwd"] >= 1, "example_quickstart: K1 never "
                                          "launched")
    require(res["grads_finite"], "example_quickstart: non-finite gradients")
    H, E, b, mask = res.pop("inputs")
    y_w, i_w = sparton_forward_with_indices(H, E, b, mask)
    y_k, i_k = k1.sparton_forward(H, E, b, mask)
    same = bool(torch.equal(y_w, y_k.to(H.dtype)) and torch.equal(i_w, i_k))
    require(same, "example_quickstart: sparton_forward_with_indices differs "
                  "from K1 on the same inputs")
    case = k1_compare(torch, H, E, b, mask, None)
    require(case["imax_hard"] == 0 and case["bit_identical"],
            f"example_quickstart: K1 against its plain version: {case}")
    emit("example_quickstart", wall_s=wall_s, launches=launches,
         k1_paths=paths, **res, with_indices_equals_k1=same,
         with_indices_vs_plain=case,
         printed=printed.getvalue().splitlines())
    return {"launches": launches, "k1_paths": paths}


def stream_compare(torch, q, C, got, want):
    """``streaming_topk``'s result against K6's by ``k6_compare``'s rule:
    values within K6_TOL of 1 + |value|, and no id differing beyond a near
    tie (``ids_beyond_near_ties``: SCORE_TOL is K6_TOL's 1e-4)."""
    (v_s, i_s), (v_k, i_k) = got, want
    err = (v_s - v_k).abs()
    hard, differ = ids_beyond_near_ties(torch, q @ C.T, i_s, i_k)
    return {"max_abs_err": float(err.max()),
            "max_rel_err": float((err / (1 + v_k.abs())).max()),
            "id_mismatch": differ, "id_hard": hard,
            "within_tol": bool((err <= K6_TOL * (1 + v_k.abs())).all())
            and hard == 0}


def per_call_ms(torch, fn, n):
    """A ``run`` for ``traced``: ``n`` calls of ``fn``, then a
    synchronise; returns the host ms a call."""
    def run():
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n
    return run


def phase_streaming(torch):
    """``launch.steps.streaming_topk`` and K6 at the JAX package's
    retrieval_cand shape (``STREAMING``): C (1000448, 128) f32 from a
    seeded generator, k 100, B 1, 8 and 64. K6 is driven through
    ``retrieve`` (``auto`` resolving to ``streaming`` on the dense
    corpus), once for each B, its launches counted; ``streaming_topk``
    (tile 65536) is held against that result by ``k6_compare``'s rule;
    then ``time_k6`` (K6, its plain version, ``torch.topk(q @ C.T)``, the
    bound, the peak MB of kernel and library) and ``streaming_topk``'s
    CUDA-event ms and peak MB; then 5 calls of ``streaming_topk`` under
    torch.profiler (``traced``: device ms by kernel, busy share against
    its CUDA-event ms). One line for each B."""
    from repro_torch.kernels import topk_score as k6
    from repro_torch.launch.steps import streaming_topk
    from repro_torch.retrieval.score import resolve_method, retrieve

    N, D, k, tile, reps = (STREAMING[key]
                           for key in ("N", "D", "k", "tile", "reps"))
    g = torch.Generator(device="cuda").manual_seed(27)
    C = torch.randn((N, D), generator=g, device="cuda")
    queries = {B: torch.randn((B, D), generator=g, device="cuda")
               for B in STREAMING["B"]}
    require(resolve_method("auto", C) == "streaming",
            "retrieval_cand: auto does not resolve to streaming")
    reset_launches()
    with plain_guard(k6=(k6, "topk_score_plain")) as plain_on_cuda:
        results = {B: retrieve(q, C, k) for B, q in queries.items()}
    launches = read_launches()
    require(not plain_on_cuda, "streaming: K6's plain version ran on a "
                               "CUDA tensor")
    require(launches["topk_score"] == len(queries),
            f"streaming: K6 launched {launches['topk_score']} times for "
            f"{len(queries)} retrieves")
    rows = {}
    for B, q in queries.items():
        got = streaming_topk(q, C, k=k, tile=tile)
        case = stream_compare(torch, q, C, got, results[B])
        require(case["within_tol"], f"streaming at B {B}: streaming_topk "
                                    f"against K6: {case}")
        del got
        row = time_k6(torch, q, C, k, reps=reps)
        row["k6_path"] = ("stream_kernel" if B <= k6.stream_rows()
                          else "wg_kernel")
        row["stream_vs_k6"] = case
        row["stream_ms"], row["stream_ms_range"] = timed(
            torch, lambda: streaming_topk(q, C, k=k, tile=tile), reps)
        row["stream_peak_mb"] = peak_mb(
            torch, lambda: streaming_topk(q, C, k=k, tile=tile))
        # K6 is left out: torch.profiler records no kernel launched
        # through the ctypes libraries (its trace reads "not measured")
        row["stream_trace"] = traced(
            torch, per_call_ms(torch, lambda: streaming_topk(
                q, C, k=k, tile=tile), 5), row["stream_ms"], 5)
        row["c_mb"] = C.nbytes / 2**20
        emit("streaming", B=B, tile=tile, launches=launches, **row)
        rows[f"B{B}"] = row
    del C, queries, results
    torch.cuda.empty_cache()
    return {"launches": launches, "rows": rows}


# --------------------------------------------------------------------------
# 11. decoder: the dense decoders' serving paths at full width
# --------------------------------------------------------------------------

# (B, S) of build_lsr_prefill_step: llama at the JAX prefill_32k length,
# its batch of 32 cut to one card's share; gemma2 past its 4096 window
# llama's prefill at 1 x 16384: its f32 attention made the 1 x 32768 one
# ~21.5 s of the script's time (K1 alone is timed at 32768 below)
DECODER_PREFILL = {"llama": (1, 16384), "gemma2": (2, 8192)}
# gemma2-27b at full width, its depth cut to two local/global periods (the
# published 46 layers would hold 55.1 GB of bf16 weights)
GEMMA2_LAYERS = 4
# decode against causal_lm_logits: (B, positions decoded, the first
# compared, compute dtypes); llama at every position of a 64-token prompt
# at f32 (gated) and bf16 (printed), gemma2 from position 0 to 4159 at
# f32, compared where the local layers' window cuts (its 4160 host-bound
# steps at bf16 would add ~40 s to the phase)
DECODE_VS_FULL = {"llama": (4, 64, 0, ("float32", "bfloat16")),
                  "gemma2": (1, 4160, 4096, ("float32",))}
# one decode_step timed at the decode_32k cache: llama, B 4 x 32768
DECODE_32K = (4, 32768)
# Decode against the full forward, both at f32 compute on the same bf16
# weights up-cast once (TF32 off): the same function, its f32 sums over
# D 3072-4608 and d_ff 8192-36864 in another order (the decode step's
# matmuls have B rows, the full forward's B x S; the full forward walks
# the keys in chunks of 2048 with an online softmax, decode takes one
# softmax), through 28 layers. Each such sum carries a relative error of
# ~1e-6; 28 layers of 7 matmuls give ~2e-4 of a logit of magnitude ~1-5,
# and 1e-3 (absolute and relative) leaves 5x room, while a key written at
# the wrong position or a window off by one moves logits by O(0.1-1).
# The JAX package's test holds the same comparison to 1e-5 at f32 on its
# 2-layer SMOKE configs. The bf16 difference is printed, not gated.
DECODE_TOL = 1e-3
# K1 timed at llama's serve batch (the index batch: 64 docs x 16 tokens)
# and prefill lengths, and at gemma2's prefill: (name, config, B, S)
DECODER_K1_TIMING = [("serve_batch", "llama", 64, 16),
                     ("llama_1x32768", "llama", 1, 32768),
                     ("llama_2x32768", "llama", 2, 32768),
                     ("gemma2_2x8192", "gemma2", 2, 8192)]


def once(torch, fn):
    """One call: its device ms (CUDA events), the device memory it
    allocates at its peak above what was live, in MB, and its result."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return (start.elapsed_time(end),
            (torch.cuda.max_memory_allocated() - base) / 2**20, out)


def decoder_prefill(torch, cfg, params, where, shape=None, twice=False):
    """``build_lsr_prefill_step`` at ``shape`` (``DECODER_PREFILL[where]``
    unless given) on seeded tokens, every position valid: one call, its
    host ms (synchronised), K1's launches in it (one, on "tma", no plain
    version on the card), then K1 held against its plain version on the
    trunk's H captured from that call (``k1_compare``: y within K1_TOL,
    i_max equal but at near ties, two launches the same bits), and the
    prefill's y (in H's dtype, bf16, as the head returns it) equal to a
    K1 launch on that H cast to it, bit for bit. With ``twice`` a second
    call on the same tokens must give the same y bits (an MoE trunk's
    dispatch and combine use no atomics)."""
    from repro_torch.kernels import sparton as k1
    from repro_torch.launch.steps import build_lsr_prefill_step
    from repro_torch.models import transformer as tfm

    B, S = shape or DECODER_PREFILL[where]
    g = torch.Generator(device="cuda").manual_seed(31)
    tokens = torch.randint(1, cfg.vocab_size, (B, S), generator=g,
                           device="cuda", dtype=torch.int32)
    mask = torch.ones((B, S), dtype=torch.int32, device="cuda")
    step = build_lsr_prefill_step(cfg, None, n_batch=B)
    hidden = []

    def keep(name, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)       # (H, aux): the step keeps the aux
            hidden.append(out[0])
            return out
        return wrapped

    reset_launches()
    with plain_guard(k1=(k1, "sparton_forward_plain")) as plain_on_cuda, \
            patched(keep, forward_hidden=(tfm, "forward_hidden")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = step(params, {"tokens": tokens, "mask": mask})
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = read_launches()
    paths = k1_on_tma(k1, f"decoder_prefill_{where}")
    require(launches["sparton_fwd"] == 1 and not plain_on_cuda,
            f"{where} prefill: K1 launches {launches}, plain versions on "
            f"the card {plain_on_cuda}")
    require(y.shape == (B, cfg.vocab_size) and y.dtype == torch.bfloat16
            and bool(torch.isfinite(y).all()) and bool((y >= 0).all()),
            f"{where} prefill: y {tuple(y.shape)} {y.dtype}, not finite "
            f"and >= 0")
    (H,) = hidden
    require(H.shape == (B, S, cfg.d_model) and H.dtype == torch.bfloat16,
            f"{where} prefill: H {tuple(H.shape)} {H.dtype}")
    E, b = tfm.head_weights(params, cfg)
    E = E.to(H.dtype)
    cap = cfg.final_logit_softcap
    case = k1_compare(torch, H, E, b, mask, cap)
    require(case["path"] == "tma" and case["imax_hard"] == 0
            and case["bit_identical"],
            f"{where} prefill: K1 against its plain version at "
            f"{tuple(H.shape)}, softcap {cap}: {case}")
    same = torch.equal(
        y, k1.sparton_forward(H, E, b, mask, softcap=cap)[0].to(y.dtype))
    require(same, f"{where} prefill: its y differs from K1 on its H")
    out = {"shape": [B, S, cfg.d_model, cfg.vocab_size], "softcap": cap,
           "ms": 1e3 * seconds, "launches": launches, "k1_paths": paths,
           "k1_vs_plain": case, "y_equals_k1_on_h": same,
           "y_nonzero_per_row": (y > 0).sum(dim=1).tolist()}
    del H, hidden
    torch.cuda.empty_cache()
    if twice:
        again = step(params, {"tokens": tokens, "mask": mask})
        out["second_call_bit_identical"] = torch.equal(y, again)
        require(out["second_call_bit_identical"],
                f"{where} prefill: a second call gave other y bits")
        del again
    del y
    torch.cuda.empty_cache()
    return out


def decode_tokens(torch, cfg, B, S):
    """Seeded tokens of the decode comparisons."""
    g = torch.Generator(device="cuda").manual_seed(37)
    return torch.randint(1, cfg.vocab_size, (B, S), generator=g,
                         device="cuda", dtype=torch.int32)


def decode_against_full(torch, c, weights, tokens, first):
    """``build_decode_step`` from an empty cache over every position of
    ``tokens`` (B, S) against ``causal_lm_logits`` on them, compared from
    position ``first`` on: the max |difference|, the mean host ms a step,
    the largest |logit| and whether every difference lies within
    DECODE_TOL x (1 + |logit|) with finite logits (``within_tol``)."""
    from repro_torch.launch.steps import build_decode_step
    from repro_torch.models import transformer as tfm

    B, S = tokens.shape
    with torch.no_grad():
        full = tfm.causal_lm_logits(weights, c, tokens)[:, first:].clone()
    torch.cuda.empty_cache()
    cache = tfm.init_kv_cache(c, B, S, device="cuda")
    step = build_decode_step(c)
    worst = torch.zeros((), device="cuda")     # |d| - tol * (1 + |ref|)
    max_abs = torch.zeros((), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(S):
        logits, _, _ = step(weights, {
            "tokens": tokens[:, s:s + 1],
            "positions": torch.full((B,), s, dtype=torch.int32,
                                    device="cuda"),
            "cache_k": cache["k"], "cache_v": cache["v"]})
        if s >= first:
            ref = full[:, s - first]
            d = (logits - ref).abs()
            max_abs = torch.maximum(max_abs, d.max())
            worst = torch.maximum(worst, (
                d - DECODE_TOL * (1 + ref.abs())).max())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out = {"max_abs_diff": float(max_abs),
           "step_ms_mean": 1e3 * seconds / S,
           "logit_abs_max": float(full.abs().max()),
           "within_tol": (float(worst) <= 0
                          and bool(torch.isfinite(logits).all()))}
    del full, cache, logits
    torch.cuda.empty_cache()
    return out


def decode_vs_full(torch, cfg, params, where):
    """``build_decode_step`` from an empty cache over ``DECODE_VS_FULL
    [where]`` positions of seeded tokens against ``causal_lm_logits`` on
    the same tokens, at f32 compute (weights up-cast once by
    ``compute_weights``; gated at DECODE_TOL), then, where listed, at the
    config's bf16 (printed). Each step's host ms; no custom kernel is on this path (the
    decoder's LM head is a plain matmul, as in the JAX package)."""
    import dataclasses

    from repro_torch.models import transformer as tfm

    B, S, first, dtypes = DECODE_VS_FULL[where]
    tokens = decode_tokens(torch, cfg, B, S)
    out = {"batch": B, "positions": S, "compared_from": first}
    reset_launches()
    for dtype in dtypes:
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        weights = tfm.compute_weights(params, c)
        out[dtype] = decode_against_full(torch, c, weights, tokens, first)
        if dtype != "float32":
            del out[dtype]["within_tol"]
        del weights
        torch.cuda.empty_cache()
    out["launches"] = read_launches()
    require(out["float32"]["within_tol"],
            f"{where}: decode differs from causal_lm_logits at f32 by "
            f"{out['float32']['max_abs_diff']} (tolerance {DECODE_TOL} "
            f"x (1 + |logit|))")
    require(all(n == 0 for n in out["launches"].values()),
            f"{where}: decode launched {out['launches']}")
    return out


def decode_32k_step(torch, cfg, params, shape=DECODE_32K, trace=False):
    """One ``build_decode_step`` call at a (B, S) cache (llama's at
    ``DECODE_32K``, the decode_32k cache: the stacked bf16 cache written in
    place, every row at its last position): CUDA-event ms, the cache's
    bytes, and the bound: the cache and the weights (an MoE trunk's every
    expert: its dispatch runs each expert's product) read once over the
    card's memory rate. With ``trace``, two more steps under
    torch.profiler (``traced``): device ms, busy share, top kernels."""
    from repro_torch.launch.steps import build_decode_step
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_leaves

    B, S = shape
    cache = tfm.init_kv_cache(cfg, B, S, device="cuda")
    step = build_decode_step(cfg)
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (B, 1),
                                     device="cuda", dtype=torch.int32),
             "positions": torch.full((B,), S - 1, dtype=torch.int32,
                                     device="cuda"),
             "cache_k": cache["k"], "cache_v": cache["v"]}
    cache_bytes = cache["k"].nbytes + cache["v"].nbytes
    weight_bytes = sum(t.nbytes for t in tree_leaves(params))
    ms, spread = timed(torch, lambda: step(params, batch), 3)
    logits = step(params, batch)[0]
    require(logits.shape == (B, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()),
            f"decode step at a {B} x {S} cache: logits not finite")
    written = bool(cache["k"][:, :, S - 1].abs().sum(dim=(2, 3)).gt(0).all())
    require(written, f"decode step at a {B} x {S} cache: the step did not "
                     f"write the cache's last position")
    bound = 1e3 * (cache_bytes + weight_bytes) / peak_rate("bytes")
    out = {"shape": [B, S], "ms": ms, "ms_range": spread,
           "cache_bytes": cache_bytes, "weight_bytes": weight_bytes,
           "bound_ms": bound, "bound_by": "bytes",
           "bound_share": bound / ms, "last_position_written": written}
    if trace:
        def run(n=2):
            t0 = time.perf_counter()
            for _ in range(n):
                step(params, batch)
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0) / n

        out["trace"] = traced(torch, run, run(), 2)
    del cache, batch, logits
    torch.cuda.empty_cache()
    return out


def time_k1_decoder(torch, E, b, B, S, softcap):
    """K1 at (B, S) on a decoder's head weights, random bf16 H from seed
    41 (K1's products do not depend on the data), every position kept:
    its CUDA-event ms and peak MB, its bound (operations at 989 TFLOP/s
    bf16), one call each of its plain version (y within K1_TOL of K1's),
    of the one-call yardstick ``k1_library`` and of the paper's PyTorch
    baseline head (``naive``: its (B, S, V) logits in f32) with their
    peak MB; the baseline only where three f32 copies of its logits fit
    in the free memory, else "does not fit" with the bytes it needs."""
    from repro_torch.core.lm_head import lm_head_naive
    from repro_torch.kernels import sparton as k1

    V, D = E.shape
    g = torch.Generator(device="cuda").manual_seed(41)
    H = torch.randn((B, S, D), generator=g, device="cuda").to(torch.bfloat16)
    mask = torch.ones((B, S), dtype=torch.int32, device="cuda")
    bound, by = k1_bound_ms(B, S, D, V, H.element_size(), B * S)

    def kernel():
        return k1.sparton_forward(H, E, b, mask, softcap=softcap)

    ms, spread = timed(torch, kernel, 3)
    row = {"shape": [B, S, D, V], "softcap": softcap, "ms": ms,
           "ms_range": spread, "peak_mb": peak_mb(torch, kernel),
           "bound_ms": bound, "bound_by": by, "bound_share": bound / ms}
    y_k, i_k = kernel()
    row["plain_ms"], row["plain_peak_mb"], (y_p, i_p) = once(
        torch, lambda: k1.sparton_forward_plain(H, E, b, mask, softcap))
    err = (y_k - y_p).abs()
    row["max_abs_err"] = float(err.max())
    row["imax_mismatch"] = int((i_k != i_p).sum())
    row["y_max"], row["y_nonzero"] = float(y_k.max()), int((y_k > 0).sum())
    row["y_differ"] = int((y_k != y_p).sum())
    require(bool((err <= K1_TOL + K1_TOL * y_p.abs()).all()),
            f"K1 at {row['shape']}: y differs from the plain version by "
            f"{row['max_abs_err']}")
    del y_k, i_k, y_p, i_p, err
    row["library_ms"], row["library_peak_mb"], _ = once(
        torch, lambda: k1_library(torch, H, E, b, mask, softcap))
    torch.cuda.empty_cache()
    need = 3 * B * S * V * 4
    free = torch.cuda.mem_get_info()[0]
    if need <= free:
        row["naive_ms"], row["naive_peak_mb"], _ = once(
            torch, lambda: lm_head_naive(H, E, b, mask,
                                         logit_softcap=softcap))
        torch.cuda.empty_cache()
    else:
        row["naive_ms"] = row["naive_peak_mb"] = "does not fit"
    row["naive_needs_bytes"], row["free_bytes"] = need, free
    del H, mask
    torch.cuda.empty_cache()
    return row


def phase_decoder(torch):
    """The dense decoders' serving paths at full width, seeded random
    weights, bf16, the kernel head. llama3.2-3b (28 layers, D 3072, V
    128256): the serve phase's path (``phase_serve``: 16384 docs, 64
    requests, ``auto`` -> K4 in place, every K1 launch on "tma"; K4 then
    timed on its V 128256 index at the served 8 queries and all 64,
    ``time_impact``), the LSR
    prefill at B 1 x 16384 (``decoder_prefill``), decode against the full
    forward (``decode_vs_full``) and one decode step at the decode_32k
    cache; then gemma2-27b at full width, ``GEMMA2_LAYERS`` deep (D 4608,
    V 256000, window 4096 on the even layers, softcaps 50 and 30): the
    prefill at B 2 x 8192 (K1 with softcap 30.0) and decode past the
    window. Then K1 timed at ``DECODER_K1_TIMING``. Lines
    ``decoder_serve``, ``decoder_llama``, ``decoder_gemma2`` and
    ``decoder``."""
    import dataclasses

    from repro_torch.configs.gemma2_27b import CONFIG as GEMMA2
    from repro_torch.configs.llama3_2_3b import CONFIG as LLAMA
    from repro_torch.models.transformer import head_weights, init_params
    from repro_torch.retrieval.sparse_rep import stack_rows

    t0 = time.perf_counter()
    reset_launches()
    served = phase_serve(torch, LLAMA, "decoder_serve")
    serve_launches = read_launches()
    params = served.pop("params")
    res = served.pop("res")
    k4 = {f"B{q.values.shape[0]}": time_impact(
        torch, q, res["index"], SERVE["topk"], reps=20)
        for q in (res["queries"], stack_rows(res["served"]))}
    emit("decoder_serve_timing", k4=k4)
    del res
    torch.cuda.empty_cache()
    llama = {"prefill": decoder_prefill(torch, LLAMA, params, "llama"),
             "decode": decode_vs_full(torch, LLAMA, params, "llama"),
             "decode_32k": decode_32k_step(torch, LLAMA, params)}
    emit("decoder_llama", config=LLAMA.name, n_params=LLAMA.n_params,
         **llama)
    timing = {}
    E, b = head_weights(params, LLAMA)
    for name, which, B, S in DECODER_K1_TIMING:
        if which == "llama":
            timing[name] = time_k1_decoder(torch, E, b, B, S, None)
    del params, E, b
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(GEMMA2, n_layers=GEMMA2_LAYERS)
    params = init_params(torch.Generator(device="cuda").manual_seed(1), cfg)
    gemma2 = {"prefill": decoder_prefill(torch, cfg, params, "gemma2"),
              "decode": decode_vs_full(torch, cfg, params, "gemma2")}
    emit("decoder_gemma2", config=cfg.name, n_layers=cfg.n_layers,
         published_layers=GEMMA2.n_layers, n_params=cfg.n_params, **gemma2)
    E, b = head_weights(params, cfg)
    for name, which, B, S in DECODER_K1_TIMING:
        if which == "gemma2":
            timing[name] = time_k1_decoder(torch, E, b, B, S,
                                           cfg.final_logit_softcap)
    del params, E, b
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    emit("decoder", k1_timing=timing, seconds=seconds)
    return {"k1_paths": {"serve": served["k1_paths"],
                         "llama_prefill": llama["prefill"]["k1_paths"],
                         "gemma2_prefill": gemma2["prefill"]["k1_paths"]},
            "launches": {"serve": serve_launches,
                         "llama_prefill": llama["prefill"]["launches"],
                         "llama_decode": llama["decode"]["launches"],
                         "gemma2_prefill": gemma2["prefill"]["launches"],
                         "gemma2_decode": gemma2["decode"]["launches"]},
            "timing": timing, "k4": k4, "seconds": seconds}


# --------------------------------------------------------------------------
# 12. moe: the MoE decoders' serving paths at full width
# --------------------------------------------------------------------------

# (B, S) of build_lsr_prefill_step: gemma2's prefill shape, 16384 routed
# tokens (moonshot's capacity C 1920 an expert, phi3.5-moe's 2560)
MOE_PREFILL = (2, 8192)
# phi3.5-moe at full width, 8 of its 32 layers: the 32 hold 83.7 GB of
# bf16 weights, past one card. moonshot at 24 of its 48 layers (27.7 GB;
# the 48 hold 55.4 GB and fit): the whole script's timeline has no room
# for the 48-layer serve of 16384 docs (50 s)
PHI35_LAYERS = 8
MOONSHOT_LAYERS = 24
# decode against causal_lm_logits at f32 on views of the first layers (a
# 48-layer f32 copy of moonshot would take 111 GB): B 4 at positions
# 0-63, as llama's in the decoder phase
MOE_DECODE_LAYERS = 4
MOE_DECODE_VS_FULL = (4, 64)
# one decode step timed at a B 4 x 4096 cache (6.4 GB for moonshot:
# decode_32k's 4 x 32768 would need 51.5 GB beside 55.4 GB of weights)
MOE_DECODE_CACHE = (4, 4096)
# K1 timed at moonshot's serve batch (64 docs x 16 tokens) and prefill,
# and at phi3.5-moe's prefill: (name, config, B, S)
MOE_K1_TIMING = [("moonshot_serve_batch", "moonshot", 64, 16),
                 ("moonshot_2x8192", "moonshot", 2, 8192),
                 ("phi35_2x8192", "phi35", 2, 8192)]


def first_layers(cfg, params, n):
    """``cfg`` cut to its first ``n`` layers and ``params`` whose layer
    leaves are views of the first ``n`` of the stacked ones (no copy)."""
    import dataclasses

    from repro_torch.tree import tree_map

    return (dataclasses.replace(cfg, n_layers=n),
            {**params, "layers": tree_map(lambda t: t[:n],
                                          params["layers"])})


def moe_decode_vs_full(torch, cfg, params, where):
    """Decode against the full forward (``decode_against_full``) at f32
    compute, B 4 at positions 0-63, on the first ``MOE_DECODE_LAYERS``
    layers (views of the stacked params, up-cast once by
    ``compute_weights``; the router stays bf16 and is up-cast at each
    call): at ``capacity_factor`` = n_experts, where no call drops an
    assignment (gated at DECODE_TOL), and at the config's 1.25, where the
    decode step's capacity (that of B tokens) and the full forward's (B x
    S tokens) drop other assignments (printed)."""
    import dataclasses

    from repro_torch.models import transformer as tfm
    from repro_torch.models.moe import capacity

    B, S = MOE_DECODE_VS_FULL
    cut, view = first_layers(cfg, params, MOE_DECODE_LAYERS)
    c32 = dataclasses.replace(cut, compute_dtype="float32")
    tokens = decode_tokens(torch, cfg, B, S)
    out = {"batch": B, "positions": S, "n_layers": cut.n_layers}
    reset_launches()
    weights = tfm.compute_weights(view, c32)
    for name, cf in (("drop_free", float(cfg.n_experts)),
                     ("config_capacity", cfg.capacity_factor)):
        c = dataclasses.replace(c32, capacity_factor=cf)
        out[name] = {
            "capacity_factor": cf,
            "capacity": {"decode": capacity(B, cfg.n_experts, cfg.top_k, cf),
                         "full": capacity(B * S, cfg.n_experts, cfg.top_k,
                                          cf)},
            **decode_against_full(torch, c, weights, tokens, 0)}
    del weights
    torch.cuda.empty_cache()
    out["launches"] = read_launches()
    require(out["drop_free"]["within_tol"],
            f"{where}: decode differs from causal_lm_logits at f32 by "
            f"{out['drop_free']['max_abs_diff']} at a drop-free capacity "
            f"(tolerance {DECODE_TOL} x (1 + |logit|))")
    require(all(n == 0 for n in out["launches"].values()),
            f"{where}: decode launched {out['launches']}")
    return out


def time_moe_ffn(torch, cfg, params, T):
    """Layer 0's ``moe_ffn`` alone on T seeded bf16 tokens: its CUDA-event
    ms and peak MB, its bound (the three expert products over every
    expert's C rows, ``3 * 2 * E * C * D * F`` operations at 989 TFLOP/s
    bf16, against its bytes: the tokens in and out, the router and every
    expert's weights once), and the three batched products alone on an
    (E, C, D) buffer (``products_ms``): the rest is routing, the sort,
    the scatter, the gather and the combine."""
    import torch.nn.functional as F

    from repro_torch.models.moe import capacity, moe_ffn

    mlp = params["layers"]["mlp"]
    E, D, Fd, k = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.top_k
    g = torch.Generator(device="cuda").manual_seed(43)
    x = torch.randn((T, D), generator=g, device="cuda").to(torch.bfloat16)
    w = [mlp[name][0] for name in ("router", "w_gate", "w_up", "w_down")]

    def run():
        return moe_ffn(x, *w, top_k=k, capacity_factor=cfg.capacity_factor)

    C = capacity(T, E, k, cfg.capacity_factor)
    ms, spread = timed(torch, run, 3)
    flops = 3 * 2 * E * C * D * Fd
    nbytes = 2 * T * D * x.element_size() + sum(
        t.numel() * t.element_size() for t in w)
    t_ops, t_bytes = flops / peak_rate("bf16"), nbytes / peak_rate("bytes")
    buf = torch.randn((E, C, D), generator=g,
                      device="cuda").to(torch.bfloat16)

    def products():
        h = F.silu(torch.bmm(buf, w[1])) * torch.bmm(buf, w[2])
        return torch.bmm(h, w[3])

    products_ms, products_spread = timed(torch, products, 3)
    out, aux = run()
    require(out.shape == (T, D) and bool(torch.isfinite(out.float()).all())
            and bool(torch.isfinite(aux)),
            f"moe_ffn at T {T}: output not finite")
    row = {"tokens": T, "capacity": C, "ms": ms, "ms_range": spread,
           "peak_mb": peak_mb(torch, run),
           "bound_ms": 1e3 * max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "products_ms": products_ms, "products_ms_range": products_spread}
    row["bound_share"] = row["bound_ms"] / ms
    del x, buf, out, aux
    torch.cuda.empty_cache()
    return row


def moe_trunk(torch, cfg, params, where, *, decode_cache):
    """One MoE config's prefill (twice, the same bits), its decode
    comparison, a decode step at ``MOE_DECODE_CACHE`` when
    ``decode_cache``, and ``moe_ffn`` timed at the prefill's T, with its
    share of the prefill's host time over every layer."""
    out = {"prefill": decoder_prefill(torch, cfg, params, where,
                                      shape=MOE_PREFILL, twice=True),
           "decode": moe_decode_vs_full(torch, cfg, params, where)}
    if decode_cache:
        out["decode_cache_step"] = decode_32k_step(
            torch, cfg, params, MOE_DECODE_CACHE, trace=True)
    ffn = time_moe_ffn(torch, cfg, params, MOE_PREFILL[0] * MOE_PREFILL[1])
    ffn["prefill_share"] = (cfg.n_layers * ffn["ms"]
                            / out["prefill"]["ms"])
    out["moe_ffn"] = ffn
    return out


def phase_moe(torch):
    """The MoE decoders' serving paths at full width, seeded random
    weights, bf16, the kernel head. moonshot-v1-16b-a3b at full width,
    ``MOONSHOT_LAYERS`` of its 48 layers (D 2048, 64 experts top-6, V
    163840 tied): the serve
    phase's path (``phase_serve``: 16384 docs, 64 requests, ``auto`` -> K4
    in place, every K1 launch on "tma"; K4 then timed on its index at the
    served 8 queries and all 64; three encode batches traced,
    ``profile_encode``), then ``moe_trunk``: the LSR prefill at
    ``MOE_PREFILL``, decode against the full forward on its first 4
    layers, one decode step at ``MOE_DECODE_CACHE`` (traced) and
    ``moe_ffn`` alone;
    then phi3.5-moe at full width, ``PHI35_LAYERS`` deep (D 4096, 16
    experts top-2, V 32064 untied): ``moe_trunk`` without the cache step.
    Then K1 timed at ``MOE_K1_TIMING``. Lines ``moe_serve``,
    ``moe_moonshot``, ``moe_phi35`` and ``moe``."""
    import dataclasses

    from repro_torch.configs import moonshot_v1_16b
    from repro_torch.configs.phi3_5_moe import CONFIG as PHI35
    from repro_torch.models.transformer import head_weights, init_params
    from repro_torch.retrieval.sparse_rep import stack_rows
    from repro_torch.runtime.serving import make_config_encoder
    from repro_torch.tree import tree_leaves

    MOONSHOT = dataclasses.replace(moonshot_v1_16b.CONFIG,
                                   n_layers=MOONSHOT_LAYERS)
    t0 = time.perf_counter()
    reset_launches()
    served = phase_serve(torch, MOONSHOT, "moe_serve")
    serve_launches = read_launches()
    params = served.pop("params")
    res = served.pop("res")
    k4 = {f"B{q.values.shape[0]}": time_impact(
        torch, q, res["index"], SERVE["topk"], reps=20)
        for q in (res["queries"], stack_rows(res["served"]))}
    del res
    torch.cuda.empty_cache()
    encode_trace = profile_encode(
        torch, make_config_encoder(params, served["cfg"]), MOONSHOT, n=3)
    moonshot = moe_trunk(torch, MOONSHOT, params, "moonshot",
                         decode_cache=True)
    emit("moe_moonshot", config=MOONSHOT.name, n_layers=MOONSHOT.n_layers,
         published_layers=moonshot_v1_16b.CONFIG.n_layers,
         n_params=MOONSHOT.n_params,
         n_active_params=MOONSHOT.n_active_params,
         weight_bytes=sum(t.nbytes for t in tree_leaves(params)),
         encode_trace=encode_trace, **moonshot)
    timing = {}
    E, b = head_weights(params, MOONSHOT)
    for name, which, B, S in MOE_K1_TIMING:
        if which == "moonshot":
            timing[name] = time_k1_decoder(torch, E, b, B, S, None)
    del params, E, b
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(PHI35, n_layers=PHI35_LAYERS)
    params = init_params(torch.Generator(device="cuda").manual_seed(2), cfg)
    phi35 = moe_trunk(torch, cfg, params, "phi35", decode_cache=False)
    emit("moe_phi35", config=cfg.name, n_layers=cfg.n_layers,
         published_layers=PHI35.n_layers, n_params=cfg.n_params,
         published_n_params=PHI35.n_params, **phi35)
    E, b = head_weights(params, cfg)
    for name, which, B, S in MOE_K1_TIMING:
        if which == "phi35":
            timing[name] = time_k1_decoder(torch, E, b, B, S, None)
    del params, E, b
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    emit("moe", k1_timing=timing, k4=k4, seconds=seconds)
    return {"k1_paths": {"serve": served["k1_paths"],
                         "moonshot_prefill": moonshot["prefill"]["k1_paths"],
                         "phi35_prefill": phi35["prefill"]["k1_paths"]},
            "launches": {"serve": serve_launches,
                         "moonshot_prefill": moonshot["prefill"]["launches"],
                         "moonshot_decode": moonshot["decode"]["launches"],
                         "phi35_prefill": phi35["prefill"]["launches"],
                         "phi35_decode": phi35["decode"]["launches"]},
            "timing": timing, "k4": k4, "seconds": seconds}


# --------------------------------------------------------------------------
# 13. train_decoder: the dense and MoE decoders' training at full width
# --------------------------------------------------------------------------

# (a) K2 and K3 at the decoders' head shapes, B 2 x S 4096 (train_4k's
# sequence length): (name, D, V, softcap). At S 4096 and V >= 128256
# K2's routing pass keeps 8 warps' counts in shared memory and its lists
# in device memory (at S 2048, 16 warps)
DECODER_BWD = [("llama", 3072, 128256, None), ("phi3_mini", 3072, 32064, None),
               ("gemma2", 4608, 256000, 30.0),
               ("moonshot", 2048, 163840, None),
               ("phi35", 4096, 32064, None)]
DECODER_BWD_SHAPE = (2, 4096)
# (b) the gradient check (GRAD_RATIO, its in-run controls) on llama and
# moonshot at full width, 2 layers, remat off: pairs x tokens
DECODER_GRAD_CHECK = (4, 512)
DECODER_GRAD_LAYERS = 2
# (c) timed steps of the CLI's step (build_lsr_train_step) on the CLI's
# pair_loader at train_4k's S 4096, one warm-up then DECODER_TRAIN_STEPS:
# (layers, pairs, n_micro), cut from train_4k's 128 pairs and the JAX
# package's _N_MICRO 4 (llama) and 8 (gemma2, moonshot). The depths hold
# the optimizer's peak (about 28 bytes a parameter at n_micro 1, 32 at 2:
# the runner's retained state, the grads and their clipped copy, the new
# moments, the f32 update and the new params) and the activations of a
# remat step in 80 GB. ``--train-depth llama 8 12 16 18 20`` measured
# llama's peak allocation at 11.1 GiB + 3.0 a layer (35.1, 47.1, 59.1,
# 65.1 GiB), the allocator reserving 7-12 GiB more (66.1 at 16 layers,
# 77.4 of the card's 79.2 at 18); 20 layers ran out of memory (69.2 GiB
# allocated, 8.0 more in fragments). 16 is the deepest that keeps a
# margin (an H100 80GB HBM3 at 700 W).
DECODER_SEQ = 4096
LLAMA_TRAIN_LAYERS = 16
DECODER_TRAIN = {"llama": (LLAMA_TRAIN_LAYERS, 4, 2), "gemma2": (2, 2, 1),
                 "moonshot": (3, 4, 2)}
DECODER_TRAIN_STEPS = 2
# (d) the CLI's own loop (launch.train.make_runner) on llama, full width,
# 2 layers, writing its final checkpoint with bf16 params (~6 GB: at 20
# layers it would be ~24 GB)
DECODER_CKPT = {"layers": 2, "steps": 2, "pairs": 2, "seq_len": 512}


@contextlib.contextmanager
def first_backward(torch):
    """While open, the kernel head's first backward (``kernels/ops``: K2
    and K3) and the K1 forward that gave its y are copied to the host:
    yields a dict that then holds that call's ``H, E, b, mask, softcap,
    dy, y, i_max`` (the routing of a real train step)."""
    from repro_torch.kernels import ops

    forwards, got = {}, {}

    def wrap(name, fn):
        def forward(H, E, b, mask, **kw):
            y, i_max = fn(H, E, b, mask, **kw)
            if not got:
                forwards[y.data_ptr()] = (H, E, b, mask)
            return y, i_max

        def backward(dy, y, i_max, H, E, **kw):
            if not got:
                _, _, b, mask = forwards.pop(y.data_ptr())
                got.update({k: t.detach().to("cpu") for k, t in (
                    ("H", H), ("E", E), ("b", b), ("mask", mask),
                    ("dy", dy), ("y", y), ("i_max", i_max))})
                got["softcap"] = kw.get("softcap")
                forwards.clear()
            return fn(dy, y, i_max, H, E, **kw)
        return forward if name == "k1" else backward

    with patched(wrap, k1=(ops, "sparton_forward"),
                 k23=(ops, "sparton_backward")):
        yield got


@contextlib.contextmanager
def head_events(torch):
    """CUDA events around each call of the kernel head's forward (K1) and
    backward (K2 then K3) in ``kernels/ops``, with no synchronise: yields
    ``[(part, start, end), ...]``, part "k1" or "k23"."""
    from repro_torch.kernels import ops

    events = []

    def wrap(name, fn):
        def wrapped(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            events.append((name, start, end))
            return out
        return wrapped

    with patched(wrap, k1=(ops, "sparton_forward"),
                 k23=(ops, "sparton_backward")):
        yield events


def decoder_bwd_gates(torch):
    """K2 and K3 at each ``DECODER_BWD`` shape on ``bwd_inputs`` (a shared
    i_max, terms routed to the last position, y == 0 columns, a masked
    row): against their plain versions (BWD_TOL) and a second launch;
    then timed (``time_bwd``) on random bf16 H (seed 61), every position
    kept, (y, i_max) from K1 and a cotangent of scale 1e-2, beside their
    bound, plain versions and the baseline head's backward."""
    B, S = DECODER_BWD_SHAPE
    gates, timing = [], {}
    for i, (name, D, V, cap) in enumerate(DECODER_BWD):
        H, E, mask, dy, y, i_max = bwd_inputs(
            torch, B, S, D, V, torch.bfloat16, 600 + i, cap, last_wins=True)
        case = bwd_compare(torch, H, E, mask, dy, y, i_max, cap)
        gates.append({"name": name, "shape": [B, S, D, V], "softcap": cap,
                      **case})
        del H, E, mask, dy, y, i_max
        torch.cuda.empty_cache()
        timing[name] = decoder_bwd_timing(torch, B, S, D, V, cap, 61 + i)
    bad = [c for c in gates if not (c["within_tol"] and c["bit_identical"])]
    require(not bad, f"train_decoder: K2/K3 differ from their plain "
                     f"versions or between two launches: {bad[:2]}")
    return gates, timing


def decoder_bwd_timing(torch, B, S, D, V, cap, seed):
    from repro_torch.kernels.sparton import sparton_forward

    g = torch.Generator(device="cuda").manual_seed(seed)
    H = torch.randn((B, S, D), generator=g, device="cuda").to(torch.bfloat16)
    E = (torch.randn((V, D), generator=g, device="cuda") * 0.2).to(
        torch.bfloat16)
    b = torch.randn((V,), generator=g, device="cuda") * 0.2
    mask = torch.ones((B, S), dtype=torch.int32, device="cuda")
    y, i_max = sparton_forward(H, E, b, mask, softcap=cap)
    dy = torch.randn(y.shape, generator=g, device="cuda") * 1e-2
    rows = time_bwd(torch, H, E, b, mask, dy, y, i_max, reps=3,
                    plain_reps=1, library="head", softcap=cap)
    del H, E, b, mask, y, i_max, dy
    torch.cuda.empty_cache()
    return rows


def decoder_state(torch, cfg, seed):
    """A fresh train state of ``cfg`` on the card (``launch.steps.
    init_state``'s for a config cut in depth): seeded params in the
    config's dtype, zero f32 AdamW moments, step 0."""
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.optimizers import adamw

    params = init_params(torch.Generator(device="cuda").manual_seed(seed),
                         cfg)
    return {"params": params, "opt": adamw(1e-4).init(params), "step": 0}


def moe_grads_twice(torch, cfg, params, batch, n_micro):
    """The MoE step's gradients (``microbatch_grads`` over the step's
    loss) twice from the same params and batch: whether they have the
    same bits, and per leaf the largest |difference| over the leaf's
    largest |gradient| where they do not."""
    from repro_torch.launch.steps import lsr_loss, value_and_grad
    from repro_torch.optim.accumulation import microbatch_grads
    from repro_torch.tree import tree_items

    grad_fn = value_and_grad(lsr_loss(cfg))
    runs = [microbatch_grads(grad_fn, params, batch, n_micro=n_micro)
            for _ in range(2)]
    (l1, g1), (l2, g2) = ((loss, tree_items(g)) for loss, g in runs)
    rel = {name: float((g1[name] - g2[name]).abs().max()
                       / g1[name].abs().max().clamp_min(1e-30))
           for name in g1 if not torch.equal(g1[name], g2[name])}
    out = {"same_bits": not rel and torch.equal(l1, l2),
           "loss_same_bits": bool(torch.equal(l1, l2)),
           "leaves_differing": sorted(rel), "max_rel_diff":
           max(rel.values(), default=0.0), "per_leaf_rel_diff": rel}
    del runs, g1, g2
    torch.cuda.empty_cache()
    return out


def decoder_timed_steps(torch, where, cfg, pairs, n_micro, seed,
                        grads_twice=False):
    """One warm-up and ``DECODER_TRAIN_STEPS`` timed steps of
    ``build_lsr_train_step(cfg, n_micro=n_micro)`` from a fresh seeded
    state, fed by the train CLI's ``pair_loader`` at ``pairs`` x
    ``DECODER_SEQ``: each step's host ms (synchronised), its peak memory,
    its loss, its K1/K2/K3 launches (2 x n_micro each) and their summed
    CUDA-event ms (the head's share of the step); no plain version on the
    card. With ``grads_twice`` the first batch's gradients are first
    taken twice from the initial params (``moe_grads_twice``). Then, on
    the warm-up step's first backward (``first_backward``), K1, K2 and K3
    against their plain versions: the routing of a real step."""
    from repro_torch.kernels import sparton as k1
    from repro_torch.kernels import sparton_bwd as kb
    from repro_torch.launch.steps import build_lsr_train_step
    from repro_torch.launch.train import pair_loader, placer

    device = torch.device("cuda")
    out = {"config": cfg.name, "n_layers": cfg.n_layers,
           "n_params": cfg.n_params, "pairs": pairs, "seq_len": DECODER_SEQ,
           "n_micro": n_micro, "remat": cfg.remat,
           "param_dtype": cfg.param_dtype,
           "compute_dtype": cfg.compute_dtype}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = decoder_state(torch, cfg, seed)
    out["state_gib"] = torch.cuda.memory_allocated() / 2**30
    step = build_lsr_train_step(cfg, n_micro=n_micro, lr=2e-4)
    place = placer(device)
    rows = []
    with pair_loader(cfg, batch=pairs, seq_len=DECODER_SEQ,
                     device=device) as loader, \
            plain_guard(k1=(k1, "sparton_forward_plain"),
                        k2=(kb, "sparton_backward_dh_plain"),
                        k3=(kb, "sparton_backward_de_plain")
                        ) as plain_on_cuda:
        batches = iter(loader)
        batch = place(next(batches))
        if grads_twice:
            out["grads_twice"] = moe_grads_twice(torch, cfg, state["params"],
                                                 batch, n_micro)
        for i in range(1 + DECODER_TRAIN_STEPS):
            if i:
                batch = place(next(batches))
            reset_launches()
            with contextlib.ExitStack() as stack:
                events = stack.enter_context(head_events(torch))
                if i == 0:
                    routing = stack.enter_context(first_backward(torch))
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                loss = float(metrics["loss"])
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
            launches = read_launches()
            head = {k: sum(s.elapsed_time(e) for name, s, e in events
                           if name == k) for k in ("k1", "k23")}
            rows.append({"ms": ms, "loss": loss, "launches": launches,
                         "k1_paths": k1_on_tma(k1, f"train_decoder {where}"),
                         "head_ms": head,
                         "head_share": sum(head.values()) / ms,
                         "peak_gib": torch.cuda.max_memory_allocated()
                         / 2**30,
                         "reserved_gib": torch.cuda.max_memory_reserved()
                         / 2**30})
            del events
    want = 2 * n_micro
    require(not plain_on_cuda, f"train_decoder {where}: plain versions ran "
                               f"on CUDA tensors: {sorted(set(plain_on_cuda))}")
    for r in rows:
        require(all(r["launches"][k] == want for k in (
            "sparton_fwd", "sparton_bwd_dh", "sparton_bwd_de")),
            f"train_decoder {where}: K1/K2/K3 launches {r['launches']} in "
            f"a step, expected {want} each")
    losses = [r["loss"] for r in rows]
    require(all(np.isfinite(losses)), f"train_decoder {where}: non-finite "
                                      f"loss {losses}")
    require(state["step"] == 1 + DECODER_TRAIN_STEPS,
            f"train_decoder {where}: the step counter reads "
            f"{state['step']}")
    out.update(steps=rows, losses=losses,
               step_ms=[r["ms"] for r in rows[1:]],
               warmup_ms=rows[0]["ms"],
               median_step_ms=sorted(r["ms"] for r in rows[1:])[
                   DECODER_TRAIN_STEPS // 2],
               peak_gib=max(r["peak_gib"] for r in rows),
               head_share=[r["head_share"] for r in rows[1:]])
    del state, batch, step
    torch.cuda.empty_cache()
    out["real_routing"] = real_routing_gates(torch, where, routing)
    return out


def real_routing_gates(torch, where, routing):
    """K1 against its plain version on a train step's captured H (and its
    y equal to K1's on that H, bit for bit), K2 and K3 against theirs on
    the step's own (dy, y, i_max): ``k1_compare`` and ``bwd_compare``."""
    from repro_torch.kernels import sparton as k1

    r = {k: (t.cuda() if torch.is_tensor(t) else t)
         for k, t in routing.items()}
    cap = r["softcap"]
    k1_case = k1_compare(torch, r["H"], r["E"], r["b"], r["mask"], cap)
    same_y = torch.equal(k1.sparton_forward(r["H"], r["E"], r["b"],
                                            r["mask"], softcap=cap)[0],
                         r["y"])
    bwd = bwd_compare(torch, r["H"], r["E"], r["mask"], r["dy"], r["y"],
                      r["i_max"], cap)
    out = {"shape": list(r["H"].shape) + [r["E"].shape[0]], "softcap": cap,
           "g_nonzero_share": float((r["y"] > 0).float().mean()),
           "k1_vs_plain": k1_case, "y_equals_k1_on_h": same_y, "bwd": bwd}
    require(k1_case["path"] == "tma" and k1_case["imax_hard"] == 0
            and k1_case["bit_identical"] and same_y,
            f"train_decoder {where}: K1 on the step's H: {out}")
    require(bwd["within_tol"] and bwd["bit_identical"],
            f"train_decoder {where}: K2/K3 on the step's routing: {bwd}")
    del r
    torch.cuda.empty_cache()
    return out


def decoder_ckpt(torch, cfg):
    """The train CLI's own loop (``launch.train.make_runner``: its
    ``FaultTolerantRunner``, loader and async checkpointer) on ``cfg`` for
    ``DECODER_CKPT`` steps, writing its final checkpoint with bf16 params
    into a ``tempfile`` directory (removed after): the free disk before,
    the checkpoint's bytes, its host copy and write seconds, then the
    checkpoint loaded back onto the card against the runner's final
    state, bit for bit."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import store
    from repro_torch.launch.train import make_runner, pair_loader

    device = torch.device("cuda")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_decoder_ckpt_")
    try:
        free = shutil.disk_usage(ckpt_dir).free
        with pair_loader(cfg, batch=DECODER_CKPT["pairs"],
                         seq_len=DECODER_CKPT["seq_len"],
                         device=device) as loader, \
                spans(host=(store, "host_state"),
                      write=(store, "save_checkpoint")) as log:
            runner = make_runner(cfg, decoder_state(torch, cfg, 9),
                                 iter(loader), steps=DECODER_CKPT["steps"],
                                 lr=2e-4, device=device, ckpt_dir=ckpt_dir)
            state = runner.run()
        require(not runner.errors and runner.skipped_steps == [],
                f"train_decoder ckpt: the runner's steps raised "
                f"{runner.errors} or were skipped {runner.skipped_steps}")
        step_dir = Path(ckpt_dir) / f"step_{DECODER_CKPT['steps']:09d}"
        nbytes = sum(f.stat().st_size for f in step_dir.iterdir())
        t0 = time.perf_counter()
        loaded, step = store.load_checkpoint(ckpt_dir, state)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    leaves = list(zip(tensor_leaves(loaded), tensor_leaves(state),
                      strict=True))
    same = all(a.dtype == b.dtype and a.device == b.device
               and torch.equal(a, b) for a, b in leaves)
    out = {"config": cfg.name, "n_layers": cfg.n_layers,
           "steps": DECODER_CKPT["steps"], "free_disk_bytes": free,
           "ckpt_bytes": nbytes,
           "host_copy_s": [t1 - t0 for t0, t1 in log["host"]],
           "write_s": [t1 - t0 for t0, t1 in log["write"]],
           "load_s": load_s, "loaded_step": step,
           "param_dtype": str(state["params"]["embed"].dtype)[6:],
           "bf16_leaves": sum(a.dtype == torch.bfloat16 for a, _ in leaves),
           "bit_identical": same}
    require(step == DECODER_CKPT["steps"] and loaded["step"] == step
            and same and out["bf16_leaves"] > 0,
            f"train_decoder ckpt: the loaded checkpoint differs from the "
            f"runner's final state: {out}")
    del loaded, state, runner, leaves
    torch.cuda.empty_cache()
    return out


def phase_train_decoder(torch):
    """Decoder training at full width, bf16 params and compute, seeded
    random weights, the kernel head: (a) K2 and K3 at the five decoders'
    (D, V, softcap) at B 2 x S 4096 (``decoder_bwd_gates``); (b) the
    gradient check on llama3.2-3b and moonshot-v1-16b-a3b, 2 layers;
    (c) timed steps (``decoder_timed_steps``) of llama3.2-3b
    (``LLAMA_TRAIN_LAYERS`` of 28 layers), gemma2-27b (2 of 46) and
    moonshot (3 of 48) at S 4096, each with K1, K2 and K3 held against
    their plain versions on its warm-up step's routing, moonshot's first
    gradients taken twice (the MoE backward run to run); (d) the CLI's
    loop on llama, 2 layers, with a bf16 checkpoint loaded back. Lines
    ``train_decoder_kernels``, ``train_decoder_grad_check``,
    ``train_decoder_llama``, ``..._gemma2``, ``..._moonshot``,
    ``train_decoder_ckpt`` and ``train_decoder``."""
    import dataclasses

    from repro_torch.configs.gemma2_27b import CONFIG as GEMMA2
    from repro_torch.configs.llama3_2_3b import CONFIG as LLAMA
    from repro_torch.configs.moonshot_v1_16b import CONFIG as MOONSHOT

    t0 = time.perf_counter()
    gates, timing = decoder_bwd_gates(torch)
    emit("train_decoder_kernels", cases=gates, timing=timing)
    checked = {name: grad_check(torch, dataclasses.replace(
        cfg, n_layers=DECODER_GRAD_LAYERS, remat=False), DECODER_GRAD_CHECK)
        for name, cfg in (("llama", LLAMA), ("moonshot", MOONSHOT))}
    torch.cuda.empty_cache()
    emit("train_decoder_grad_check", shape=list(DECODER_GRAD_CHECK),
         n_layers=DECODER_GRAD_LAYERS, **checked)
    trained = {}
    for name, cfg, seed in (("llama", LLAMA, 3), ("gemma2", GEMMA2, 4),
                            ("moonshot", MOONSHOT, 5)):
        layers, pairs, n_micro = DECODER_TRAIN[name]
        trained[name] = decoder_timed_steps(
            torch, name, dataclasses.replace(cfg, n_layers=layers), pairs,
            n_micro, seed, grads_twice=cfg.is_moe)
        emit(f"train_decoder_{name}", published_layers=cfg.n_layers,
             **trained[name])
    ckpt = decoder_ckpt(torch, dataclasses.replace(
        LLAMA, n_layers=DECODER_CKPT["layers"]))
    emit("train_decoder_ckpt", **ckpt)
    seconds = time.perf_counter() - t0
    emit("train_decoder", seconds=seconds,
         moe_grads_same_bits=trained["moonshot"]["grads_twice"]["same_bits"])
    return {"launches": {name: t["steps"][-1]["launches"]
                         for name, t in trained.items()},
            "k1_paths": {name: t["steps"][-1]["k1_paths"]
                         for name, t in trained.items()},
            "timing": timing, "seconds": seconds}


TRAIN_DEPTH_ARCHS = {"llama": "llama3_2_3b", "gemma2": "gemma2_27b",
                     "moonshot": "moonshot_v1_16b"}


def train_depth(torch, argv) -> int:
    """``python3 chip_smoke.py --train-depth ARCH L [L ...]``: the peak
    memory and step time that set the train_decoder depths. Each depth
    runs in a process of its own (``--one``; an out-of-memory error
    leaves nothing behind for the next): ``decoder_timed_steps`` at full
    width with ``DECODER_TRAIN[ARCH]``'s pairs and n_micro at S 4096,
    every gate held. One JSON line a depth: the peak GiB allocated and
    reserved, the state's GiB, each step's ms and the head's share, or
    ``"fits": false`` and the out-of-memory error."""
    import argparse
    import dataclasses

    from repro_torch.configs import get_config

    ap = argparse.ArgumentParser(prog="chip_smoke.py --train-depth")
    ap.add_argument("--train-depth", dest="arch", required=True,
                    choices=sorted(TRAIN_DEPTH_ARCHS))
    ap.add_argument("layers", type=int, nargs="+")
    ap.add_argument("--one", action="store_true")
    args = ap.parse_args(argv)
    if not args.one:
        phase_device(torch)
        phase_build()
        for layers in args.layers:
            code = subprocess.run([sys.executable, __file__, "--train-depth",
                                   args.arch, "--one", str(layers)]).returncode
            if code:
                return code
        return 0
    (layers,) = args.layers
    cfg = dataclasses.replace(
        get_config(TRAIN_DEPTH_ARCHS[args.arch]).CONFIG, n_layers=layers)
    _, pairs, n_micro = DECODER_TRAIN[args.arch]
    line = {"phase": "train_depth", "arch": args.arch, "n_layers": layers,
            "pairs": pairs, "n_micro": n_micro, "seq_len": DECODER_SEQ}
    try:
        out = decoder_timed_steps(torch, args.arch, cfg, pairs, n_micro, 3)
    except torch.cuda.OutOfMemoryError as e:
        print(json.dumps({**line, "fits": False, "error": str(e)[:400]}),
              flush=True)
        return 0
    print(json.dumps({
        **line, "fits": True, "state_gib": out["state_gib"],
        "peak_gib": out["peak_gib"],
        "reserved_gib": max(r["reserved_gib"] for r in out["steps"]),
        "warmup_ms": out["warmup_ms"], "step_ms": out["step_ms"],
        "head_share": out["head_share"]}), flush=True)
    return 0


# --------------------------------------------------------------------------
# 14. recsys: DLRM, xDeepFM, DIEN and Wide&Deep at published width
# --------------------------------------------------------------------------

# name: the config module. Every family runs its CONFIG, f32 params and
# compute as the configs say, but DLRM's tables: their 187,838,464 padded
# rows (96.2 GB of f32) fit on no one card, so each is capped at
# DLRM_ROW_CAP rows (13,750,272 rows, 7.04 GB), the batches drawn from the
# capped sizes; the one cut of scale, until row sharding (item 10)
RECSYS = {"dlrm": "dlrm_mlperf", "xdeepfm": "xdeepfm", "dien": "dien",
          "wide_deep": "wide_deep"}
DLRM_ROW_CAP = 2**21
RECSYS_STEPS = 3          # runner steps at train_batch, after one probe step
RECSYS_SERVE_REPS = {"serve_p99": 20, "serve_bulk": 2}
# the retrieval_cand shape: B 1 against 1,000,000 candidates padded to a
# multiple of 512 (the JAX package's configs/specs.py:207), k 100
RECSYS_RETRIEVAL = {"N": 1000448, "k": 100, "reps": 10}


def recsys_config(name):
    """The family's published CONFIG (DLRM's tables capped at
    ``DLRM_ROW_CAP`` rows) and the rows cut, as a dict."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.recsys import padded_rows

    cfg = get_config(RECSYS[name]).CONFIG
    if name != "dlrm":
        return cfg, None
    capped = tuple(min(rows, DLRM_ROW_CAP) for rows in cfg.table_sizes)
    cut = {"row_cap": DLRM_ROW_CAP,
           "padded_rows": sum(padded_rows(r) for r in cfg.table_sizes),
           "capped_padded_rows": sum(padded_rows(r) for r in capped),
           "tables_capped": sum(c < r for c, r in zip(capped,
                                                      cfg.table_sizes))}
    return dataclasses.replace(cfg, table_sizes=capped), cut


def recsys_batch(torch, cfg, B, seed, device):
    """One ``recsys_batches`` draw of B rows on ``device``."""
    from repro_torch.data.synthetic import recsys_batches

    host = next(recsys_batches(batch=B, n_dense=cfg.n_dense,
                               n_sparse=cfg.n_sparse,
                               table_sizes=cfg.table_sizes,
                               seq_len=cfg.seq_len, seed=seed))
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


def largest_fitting(torch, fn, B, floor=1):
    """Call ``fn(B)`` at B, B / 2, ... until it does not run out of
    memory: ``(B, result, [every B tried])``."""
    tried = []
    while True:
        tried.append(B)
        try:
            return B, fn(B), tried
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            require(B // 2 >= floor, f"recsys: out of memory down to B {B}")
            B //= 2


def recsys_train(torch, name, cfg, launches):
    """The train CLI's loop on ``cfg`` at train_batch: one probe step of
    ``build_recsys_train_step`` (halving the batch until it fits, every
    batch tried printed), then ``launch.train.make_runner`` over the CLI's
    ``recsys_loader`` for ``RECSYS_STEPS`` steps from a fresh seeded state
    (Adagrad at the CLI's 1e-2), its final checkpoint written into a
    ``tempfile`` directory (removed after). The runner's step seconds,
    the peak memory over its steps, each loss (finite, the last not above
    the first), no step raised or skipped, and K1-K6 launched no time."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import store
    from repro_torch.configs.base import SHAPES_RECSYS
    from repro_torch.launch.steps import build_recsys_train_step, new_state
    from repro_torch.launch.train import make_runner, recsys_loader

    device = torch.device("cuda")
    g = torch.Generator(device=device).manual_seed(31)
    state = new_state(cfg, g)
    torch.cuda.synchronize()
    state_gib = torch.cuda.memory_allocated() / 2**30
    step = build_recsys_train_step(cfg)

    def probe(B):
        batch = recsys_batch(torch, cfg, B, 5, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, m = step(state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        del out, batch
        return {"ms": ms, "loss": loss}

    B, probed, tried = largest_fitting(
        torch, probe, SHAPES_RECSYS["train_batch"].batch)
    torch.cuda.empty_cache()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_recsys_ckpt_")
    reset_launches()
    try:
        with recsys_loader(cfg, batch=B, device=device) as loader, \
                spans(host=(store, "host_state"),
                      write=(store, "save_checkpoint")) as log:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            runner = make_runner(cfg, state, iter(loader),
                                 steps=RECSYS_STEPS, lr=None, device=device,
                                 ckpt_dir=ckpt_dir)
            del state
            state = runner.run()
            peak = torch.cuda.max_memory_allocated() / 2**30
            reserved = torch.cuda.max_memory_reserved() / 2**30
        ckpt_bytes = sum(f.stat().st_size for f in
                         (Path(ckpt_dir) / f"step_{RECSYS_STEPS:09d}"
                          ).iterdir())
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    launches[f"{name}_train"] = read_launches()
    logged = [m for m in runner.metrics_log if "loss" in m]
    losses = [float(m["loss"]) for m in logged]
    out = {"batch": B, "batches_tried": tried, "probe": probed,
           "state_gib": state_gib, "losses": losses,
           "step_ms": [1e3 * m["step_time_s"] for m in logged],
           "peak_gib": peak, "reserved_gib": reserved,
           "ckpt_bytes": ckpt_bytes,
           "ckpt_host_copy_s": [t1 - t0 for t0, t1 in log["host"]],
           "ckpt_write_s": [t1 - t0 for t0, t1 in log["write"]]}
    out["median_step_ms"] = sorted(out["step_ms"])[len(logged) // 2]
    require(not runner.errors and runner.skipped_steps == []
            and len(losses) == RECSYS_STEPS and state["step"] == RECSYS_STEPS,
            f"recsys {name}: the runner's steps raised {runner.errors} or "
            f"were skipped {runner.skipped_steps}")
    require(all(np.isfinite(losses)) and losses[-1] <= losses[0],
            f"recsys {name}: losses {losses} not finite or rising")
    require(not any(launches[f"{name}_train"].values()),
            f"recsys {name}: a kernel launched in the train step: "
            f"{launches[f'{name}_train']}")
    return out, state


def recsys_serve(torch, name, cfg, params, launches):
    """``build_recsys_serve_step`` at serve_p99 and serve_bulk (halved until
    it fits, every batch tried printed): CUDA-event ms a call, peak MB,
    probabilities finite and in [0, 1], on the card."""
    from repro_torch.configs.base import SHAPES_RECSYS
    from repro_torch.launch.steps import build_recsys_serve_step

    serve = build_recsys_serve_step(cfg)
    rows = {}
    for shape in ("serve_p99", "serve_bulk"):
        def run(B):
            batch = recsys_batch(torch, cfg, B, 6, torch.device("cuda"))
            p = serve(params, batch)
            torch.cuda.synchronize()
            return batch, p

        reset_launches()
        B, (batch, p), tried = largest_fitting(
            torch, run, SHAPES_RECSYS[shape].batch)
        launches[f"{name}_{shape}"] = read_launches()
        ok = bool(p.is_cuda and p.shape == (B,) and torch.isfinite(p).all()
                  and ((p >= 0) & (p <= 1)).all())
        row = {"batch": B, "batches_tried": tried, "prob_mean": float(p.mean()),
               "prob_range": [float(p.min()), float(p.max())],
               "probabilities": ok}
        del p
        row["ms"], row["ms_range"] = timed(
            torch, lambda: serve(params, batch), RECSYS_SERVE_REPS[shape])
        row["peak_mb"] = peak_mb(torch, lambda: serve(params, batch))
        require(ok, f"recsys {name} {shape}: {row}")
        rows[shape] = row
        del batch
        torch.cuda.empty_cache()
    return rows


def recsys_retrieval(torch, name, cfg, params, launches):
    """``build_retrieval_step`` at retrieval_cand: B 1, candidates
    ``(RECSYS_RETRIEVAL["N"], embed_dim)`` f32 from a seeded generator, k
    100. Its ids held against K6 (``topk_score``) and the library's
    ``topk_rows(q @ C.T)`` on the same query vector and candidates
    (``stream_compare``'s rule: values within K6_TOL of 1 + |value|, ids
    equal but at near ties); the step's CUDA-event ms and peak MB; K6
    timed on those inputs beside its bound (``time_k6``)."""
    from repro_torch.configs.base import SHAPES_RECSYS
    from repro_torch.kernels.topk_score import topk_rows, topk_score
    from repro_torch.launch.steps import build_retrieval_step
    from repro_torch.models.recsys import user_embedding

    N, k, reps = (RECSYS_RETRIEVAL[key] for key in ("N", "k", "reps"))
    shape = SHAPES_RECSYS["retrieval_cand"]
    require(N == shape.n_candidates + (-shape.n_candidates) % 512,
            "recsys: retrieval_cand's padded N")
    g = torch.Generator(device="cuda").manual_seed(37)
    batch = recsys_batch(torch, cfg, shape.batch, 7, torch.device("cuda"))
    batch["candidates"] = torch.randn((N, cfg.embed_dim), generator=g,
                                      device="cuda")
    C = batch["candidates"]
    retrieve = build_retrieval_step(cfg, None, k=k)
    reset_launches()
    vals, idx = retrieve(params, batch)
    torch.cuda.synchronize()
    launches[f"{name}_retrieval"] = read_launches()
    require(not any(launches[f"{name}_retrieval"].values()),
            f"recsys {name}: a kernel launched in the retrieval step: "
            f"{launches[f'{name}_retrieval']}")
    with torch.no_grad():
        qv = user_embedding(params, cfg, batch)
    vs_k6 = stream_compare(torch, qv, C, (vals, idx), topk_score(qv, C, k=k))
    vs_library = stream_compare(torch, qv, C, (vals, idx),
                                topk_rows(qv @ C.T, k))
    row = {"shape": {"B": qv.shape[0], "N": N, "D": cfg.embed_dim, "k": k},
           "on_cuda": bool(idx.is_cuda), "vs_k6": vs_k6,
           "vs_library": vs_library}
    require(row["on_cuda"] and vs_k6["within_tol"] and vs_library["within_tol"],
            f"recsys {name} retrieval: {row}")
    row["ms"], row["ms_range"] = timed(torch, lambda: retrieve(params, batch),
                                       reps)
    row["peak_mb"] = peak_mb(torch, lambda: retrieve(params, batch))
    row["k6"] = time_k6(torch, qv, C, k, reps=reps)
    del batch, C, vals, idx
    torch.cuda.empty_cache()
    return row


def phase_recsys(torch):
    """The recsys family at published width (f32, TF32 off), one family at
    a time: (a) training through the train CLI's loop (``recsys_train``),
    (b) the serve step at serve_p99 and serve_bulk (``recsys_serve``) and
    (c) the retrieval step at retrieval_cand held against K6 and the
    library (``recsys_retrieval``), on the trained params. No kernel is
    on these paths: K1-K6 must launch no time in any of them (K6's
    launches here are its comparisons and timing). One ``recsys_<name>``
    line a family, then ``recsys``."""
    t0 = time.perf_counter()
    rows, launches = {}, {}
    for name in RECSYS:
        t1 = time.perf_counter()
        cfg, cut = recsys_config(name)
        train, state = recsys_train(torch, name, cfg, launches)
        params = state["params"]
        del state
        torch.cuda.empty_cache()
        row = {"config": cfg.name, "interaction": cfg.interaction,
               "embed_dim": cfg.embed_dim, "n_tables": len(cfg.table_sizes),
               "rows_cut": cut, "train": train,
               "serve": recsys_serve(torch, name, cfg, params, launches),
               "retrieval": recsys_retrieval(torch, name, cfg, params,
                                             launches)}
        del params
        torch.cuda.empty_cache()
        row["seconds"] = time.perf_counter() - t1
        emit(f"recsys_{name}", **row)
        rows[name] = row
    seconds = time.perf_counter() - t0
    emit("recsys", seconds=seconds,
         batches={name: {"train": r["train"]["batch"],
                         **{s: r["serve"][s]["batch"] for s in r["serve"]}}
                  for name, r in rows.items()},
         dlrm_rows_cut=rows["dlrm"]["rows_cut"])
    return {"launches": launches,
            "k6": {f"{name}_D{r['embed_dim']}": r["retrieval"]["k6"]
                   for name, r in rows.items()},
            "seconds": seconds}


# --------------------------------------------------------------------------
# 15. dimenet
# --------------------------------------------------------------------------

# DimeNet's full CONFIG (6 blocks, d 128, bilinear 8, spherical 7, radial
# 6), f32 with TF32 off, at the three SHAPES_GNN shapes one card holds,
# d_feat per shape as the JAX package's cells set it (atom types at
# molecule, the datasets' feature widths: configs/specs.py:152)
DIMENET_D_FEAT = {"molecule": 0, "full_graph_sm": 1433, "minibatch_lg": 602}
DIMENET_STEPS = 5          # timed steps at each shape, after the first
DIMENET_LEARN = (10, 2e-3)  # molecule: steps on one batch at this lr, as
#                             examples/train_dimenet.py trains
TRIPLET_PAD = 512          # flat triplets padded to a multiple, t_mask 0
# the card's loss and gradients against the port's same step on the CPU,
# and the flat layout against the dense one: f32 sums in other orders
# (cuBLAS's blocked products, the sorted segment sums' runs against the
# CPU's serial index_add_) through 6 blocks, relative to each leaf's
# (each output's) largest |value|. A leaf whose f32 step is that sensitive
# to the order (the untrained CONFIG's outputs reach ~1e3, a cora hub
# sums ~4000 edges) passes if the card's f32 gradient is no further from
# the f64 step than twice the CPU's f32 gradient is (its in-run control);
# the card's f64 step equals the CPU's f64 step within DIMENET_F64_TOL
DIMENET_TOL = 1e-4
DIMENET_F64_TOL = 1e-9
GRAPH_BUILD_S = 60         # minibatch_lg: the host graph's time budget
# a full build's seconds over its 1/16 probe's: 16x the edges, and the
# stable sort's log factor and cache misses on top (21.3x measured on the
# H100 machine's host)
GRAPH_PROBE_SCALE = 22.4
OGB_SKIP = ("ogb_products needs more than one card: its padded E of "
            "61,859,328 x K 8 x d 128 in f32 is 253 GB of gathered messages "
            "for one block (m (E, 128) alone 31.7 GB); it waits for "
            "multi-GPU, ROADMAP Queue 1 item 10")


def pad512(n):
    return n + (-n) % 512


def dimenet_config(shape):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("dimenet").CONFIG,
                               d_feat=DIMENET_D_FEAT[shape])


def flat_triplets(t_in, t_out):
    """Flat triplets padded to a multiple of ``TRIPLET_PAD`` (t_mask 0)."""
    T = len(t_in)
    out = {k: np.zeros(T + (-T) % TRIPLET_PAD, np.int32)
           for k in ("t_in", "t_out", "t_mask")}
    out["t_in"][:T], out["t_out"][:T], out["t_mask"][:T] = t_in, t_out, 1
    return out


def real_edge_triplets(b, n_nodes, cap):
    """Capped triplets of the real edges only (``edge_mask`` 1, a prefix),
    flat and densified to ``(E, cap)``, and the host seconds of each: the
    padded tail (0 -> 0) gets none. (Over the padded arrays, as
    ``molecule_batches`` users build them, every padded edge scans node
    0's padded in-edges: ``build_triplets`` goes quadratic in the ~145k
    padded edges of minibatch_lg.)"""
    from repro_torch.sparse.triplets import build_triplets, densify_triplets

    n = int(b["edge_mask"].sum())
    require(b["edge_mask"][:n].all(), "dimenet: real edges are a prefix")
    t0 = time.perf_counter()
    t_in, t_out = build_triplets(b["edge_src"][:n], b["edge_dst"][:n],
                                 n_nodes, max_per_edge=cap)
    t1 = time.perf_counter()
    dense, mask = densify_triplets(t_in, t_out, len(b["edge_src"]), cap)
    t2 = time.perf_counter()
    return (t_in, t_out), (dense, mask), {"triplets_s": t1 - t0,
                                          "densify_s": t2 - t1}


def molecule_host():
    """(a) 128 molecules of 30 atoms, at most 64 edges each
    (``molecule_batches``), exact triplets over its padded arrays (as
    ``examples/train_dimenet.py`` builds them), flat, padded to a
    multiple of ``TRIPLET_PAD``."""
    from repro_torch.configs.base import SHAPES_GNN
    from repro_torch.data.synthetic import molecule_batches
    from repro_torch.sparse.triplets import build_triplets

    spec = SHAPES_GNN["molecule"]
    t0 = time.perf_counter()
    b = next(molecule_batches(n_graphs=spec.n_graphs,
                              nodes_per_graph=spec.n_nodes,
                              edges_per_graph=spec.n_edges, seed=0))
    t1 = time.perf_counter()
    b.update(flat_triplets(*build_triplets(
        b["edge_src"], b["edge_dst"], spec.n_graphs * spec.n_nodes)))
    return b, {"molecules_s": t1 - t0,
               "triplets_s": time.perf_counter() - t1}


def full_graph_host(cfg):
    """(b) cora-size: ``make_synthetic_graph(2708, 10556)`` padded to the
    JAX cell's multiples of 512 (N 3072, E 10752; masked), positions
    uniform in [0, 1.2 cutoff)^3 as ``molecule_batches`` draws them,
    ``node_feat`` (N, 1433) and per-node targets normal; capped
    triplets (K 8) of the real edges, flat and dense."""
    from repro_torch.configs.base import SHAPES_GNN
    from repro_torch.data.synthetic import make_synthetic_graph

    spec = SHAPES_GNN["full_graph_sm"]
    t0 = time.perf_counter()
    src, dst = make_synthetic_graph(spec.n_nodes, spec.n_edges, seed=0)
    N, E = pad512(spec.n_nodes), pad512(spec.n_edges)
    rng = np.random.default_rng(41)
    b = {k: np.zeros(E, np.int32) for k in ("edge_src", "edge_dst",
                                             "edge_mask")}
    b["edge_src"][:len(src)], b["edge_dst"][:len(src)] = src, dst
    b["edge_mask"][:len(src)] = 1
    b.update(positions=rng.uniform(0, cfg.cutoff * 1.2, size=(N, 3)).astype(
                 np.float32),
             node_feat=rng.normal(size=(N, cfg.d_feat)).astype(np.float32),
             node_mask=(np.arange(N) < spec.n_nodes).astype(np.int32),
             target=rng.normal(size=(N, cfg.n_targets)).astype(np.float32))
    t1 = time.perf_counter()
    flat, dense, secs = real_edge_triplets(
        b, N, cfg.max_triplets_per_edge)
    return b, flat, dense, {"graph_s": t1 - t0, **secs}


def minibatch_host(cfg, spec):
    """(c) Reddit-size: a host graph of the published 232,965 nodes and
    114,615,892 edges (``make_synthetic_graph``, then
    ``CSRGraph.from_edges``), cut only if a 1/16 probe predicts it would
    take more than ``GRAPH_BUILD_S`` (``GRAPH_PROBE_SCALE`` times the
    probe); 1024 seeds fanned out (15, 10) by
    ``sample_subgraph``, padded to ``fanout_budget`` (N 169984, E 168960),
    the two hops' blocks concatenated; ``node_feat`` (N, 602), positions
    as (b), one target a seed; capped triplets (K 8) of the real edges,
    densified to (168960, 8)."""
    from repro_torch.data.synthetic import make_synthetic_graph
    from repro_torch.sparse.sampler import (CSRGraph, fanout_budget,
                                            sample_subgraph)

    n, E = spec.n_nodes, spec.n_edges

    def graph(n_edges):
        t0 = time.perf_counter()
        src, dst = make_synthetic_graph(n, n_edges, seed=0)
        g = CSRGraph.from_edges(src, dst, n)
        return g, time.perf_counter() - t0

    _, probe_s = graph(E // 16)
    predicted = probe_s * GRAPH_PROBE_SCALE
    n_edges = E if predicted <= GRAPH_BUILD_S else \
        int(E * GRAPH_BUILD_S / predicted)
    g, graph_s = graph(n_edges)
    out_degree = np.diff(g.indptr)
    t0 = time.perf_counter()
    rng = np.random.default_rng(43)
    seeds = rng.choice(n, spec.batch_nodes, replace=False)
    N, per_hop = fanout_budget(spec.batch_nodes, spec.fanout)
    sub = sample_subgraph(g, seeds, spec.fanout, rng=rng, pad_nodes=N,
                          pad_edges_per_hop=per_hop)
    del g
    t1 = time.perf_counter()
    b = {"edge_src": np.concatenate([x.src for x in sub.blocks]),
         "edge_dst": np.concatenate([x.dst for x in sub.blocks]),
         "edge_mask": np.concatenate([x.mask for x in sub.blocks]),
         "positions": rng.uniform(0, cfg.cutoff * 1.2, size=(N, 3)).astype(
             np.float32),
         "node_feat": rng.normal(size=(N, cfg.d_feat)).astype(np.float32),
         "node_mask": sub.node_mask, "seed_ids": sub.seeds,
         "target": rng.normal(size=(spec.batch_nodes, cfg.n_targets)
                              ).astype(np.float32)}
    # the sampler pads each hop behind its real edges: make them a prefix
    order = np.argsort(-b["edge_mask"], kind="stable")
    for k in ("edge_src", "edge_dst", "edge_mask"):
        b[k] = b[k][order]
    t2 = time.perf_counter()
    _, dense, secs = real_edge_triplets(b, N, cfg.max_triplets_per_edge)
    cut = None if n_edges == E else {
        "edges": n_edges, "of": E, "probe_s": probe_s,
        "predicted_full_s": predicted}
    return b, dense, {"graph_probe_s": probe_s, "graph_s": graph_s,
                      "sample_s": t1 - t0, "features_s": t2 - t1, **secs}, {
        "edges_cut": cut, "min_out_degree": int(out_degree.min()),
        "real_nodes": sub.n_nodes,
        "real_edges": [x.n_edges for x in sub.blocks]}


def start_minibatch_host():
    """``minibatch_host`` in a spawned process while the earlier phases
    run (its minute of numpy would otherwise sit in the script's time
    limit): the pending result, for ``phase_dimenet``. The process is
    terminated when the script exits."""
    import atexit
    import multiprocessing

    from repro_torch.configs.base import SHAPES_GNN

    pool = multiprocessing.get_context("spawn").Pool(1)
    atexit.register(pool.terminate)
    return pool.apply_async(minibatch_host, (dimenet_config("minibatch_lg"),
                                             SHAPES_GNN["minibatch_lg"]))


def on(torch, host, device):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in host.items()}


def leaf_errors(torch, got, want):
    """Each leaf's largest |got - want| over its largest |want|, worst
    first: [(path, ratio)]."""
    from repro_torch.tree import tree_items

    errs = []
    for path, w in tree_items(want).items():
        g = tree_items(got)[path].cpu()
        scale = float(w.abs().max()) or 1.0
        errs.append((path, float((g - w).abs().max()) / scale))
    return sorted(errs, key=lambda e: -e[1])


def same_bits_tree(torch, a, b):
    from repro_torch.tree import tree_leaves

    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def gnn_grads(torch, cfg, n_graphs, state, batch, *, cpu):
    """One step's loss and gradients (``gnn_loss`` through
    ``value_and_grad``) on the card twice (whether they give the same
    bits) and, with ``cpu``, the port's same step on the CPU from the same
    state and batch, at f32 and at f64 (both devices): the loss within
    ``DIMENET_TOL``, each leaf within ``DIMENET_TOL`` of its largest
    |value| or of its control (``DIMENET_TOL``'s note), the f64 steps
    within ``DIMENET_F64_TOL``."""
    from repro_torch.launch.steps import gnn_loss, value_and_grad
    from repro_torch.tree import tree_map

    grad_fn = value_and_grad(gnn_loss(cfg, n_graphs))
    loss, grads = grad_fn(state["params"], batch)
    loss2, grads2 = grad_fn(state["params"], batch)
    out = {"loss": float(loss),
           "two_runs_same_bits": bool(torch.equal(loss, loss2)
                                      and same_bits_tree(torch, grads,
                                                         grads2))}
    del grads2
    if not cpu:
        return out

    def f64(x):
        return x.double() if x.is_floating_point() else x

    def step_on(device, cast=lambda x: x):
        return grad_fn(tree_map(lambda x: cast(x).to(device),
                                state["params"]),
                       {k: cast(v).to(device) for k, v in batch.items()})

    t0 = time.perf_counter()
    h_loss, h_grads = step_on("cpu")
    cpu_s = time.perf_counter() - t0
    h64_loss, h64 = step_on("cpu", f64)
    c64_loss, c64 = step_on("cuda", f64)
    card = dict(leaf_errors(torch, grads, h_grads))
    card_64 = dict(leaf_errors(torch, grads, h64))
    cpu_64 = dict(leaf_errors(torch, h_grads, h64))
    f64_errs = leaf_errors(torch, c64, h64)
    held = {path: card[path] <= DIMENET_TOL
            or card_64[path] <= 2 * cpu_64[path] for path in card}
    worst = sorted(card, key=lambda p: -card[p])[:3]
    res = {"cpu_loss": float(h_loss), "cpu_s": cpu_s,
           "loss_rel": abs(float(loss) - float(h_loss))
           / max(abs(float(h_loss)), 1e-30),
           "worst_leaves": [{"leaf": p, "card_vs_cpu": card[p],
                             "card_vs_f64": card_64[p],
                             "cpu_vs_f64": cpu_64[p]} for p in worst],
           "leaves": len(card),
           "leaves_beyond_tol": sum(v > DIMENET_TOL for v in card.values()),
           "f64_loss_rel": abs(float(c64_loss) - float(h64_loss))
           / max(abs(float(h64_loss)), 1e-30),
           "f64_worst_leaf": f64_errs[0]}
    res["within_tol"] = (res["loss_rel"] <= DIMENET_TOL and all(held.values())
                         and res["f64_loss_rel"] <= DIMENET_F64_TOL
                         and f64_errs[0][1] <= DIMENET_F64_TOL)
    out["vs_cpu"] = res
    return out


def gnn_steps(torch, cfg, n_graphs, state, batch, n, lr):
    """``n`` steps of ``build_gnn_train_step`` on one batch: each step's
    CUDA-event ms (synchronised), its loss, the peak memory over them."""
    from repro_torch.launch.steps import build_gnn_train_step

    step = build_gnn_train_step(cfg, n_graphs=n_graphs, lr=lr)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, batch)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
    return state, {
        "lr": lr, "losses": losses, "first_ms": ms[0], "step_ms": ms[1:],
        "median_step_ms": sorted(ms[1:])[(n - 1) // 2],
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "peak_above_inputs_gib": (torch.cuda.max_memory_allocated() - base)
        / 2**30}


def dimenet_shape(torch, name, cfg, host, *, n_graphs=0, cpu, steps, lr):
    """One shape: the batch on the card once, a fresh seeded state,
    ``gnn_grads`` (the CPU comparison with ``cpu``), then ``steps`` train
    steps; K1-K6 must launch no time."""
    from repro_torch.launch.steps import new_state

    device = torch.device("cuda")
    batch = on(torch, host, device)
    state = new_state(cfg, torch.Generator(device=device).manual_seed(47))
    reset_launches()
    row = {"config": cfg.name, "d_feat": cfg.d_feat,
           "nodes": int(batch["node_mask"].shape[0]),
           "edges": int(batch["edge_src"].shape[0]),
           "real_edges": int(host["edge_mask"].sum())}
    if "t_in_dense" in host:
        row["triplet_slots"] = list(host["t_in_dense"].shape)
        row["real_triplets"] = int(host["t_mask_dense"].sum())
    else:
        row["triplet_slots"] = len(host["t_in"])
        row["real_triplets"] = int(host["t_mask"].sum())
    row["grads"] = gnn_grads(torch, cfg, n_graphs, state, batch, cpu=cpu)
    state, row["train"] = gnn_steps(torch, cfg, n_graphs, state, batch, steps,
                                    lr)
    row["launches"] = read_launches()
    losses = row["train"]["losses"]
    require(all(np.isfinite(losses)), f"dimenet {name}: losses {losses}")
    require(not any(row["launches"].values()),
            f"dimenet {name}: a kernel launched: {row['launches']}")
    require(row["grads"]["two_runs_same_bits"],
            f"dimenet {name}: two runs of one step differ: {row['grads']}")
    if cpu:
        require(row["grads"]["vs_cpu"]["within_tol"],
                f"dimenet {name}: card vs CPU {row['grads']['vs_cpu']}")
    return row, state, batch


def flat_vs_dense(torch, cfg, params, batch, flat):
    """(b)'s ``forward`` on the flat capped triplets against its dense
    layout on the same params, within ``DIMENET_TOL`` of the largest
    |output|."""
    from repro_torch.models.dimenet import forward

    flat_batch = {k: v for k, v in batch.items() if not k.startswith("t_")}
    flat_batch.update(on(torch, flat, batch["edge_src"].device))
    with torch.no_grad():
        a = forward(params, cfg, flat_batch)
        b = forward(params, cfg, batch)
    err = float((a - b).abs().max()) / (float(b.abs().max()) or 1.0)
    return {"max_rel": err, "within_tol": err <= DIMENET_TOL,
            "flat_triplets": int(flat_batch["t_mask"].sum())}


def phase_dimenet(torch, minibatch=None):
    """DimeNet's full CONFIG trained on the card through
    ``build_gnn_train_step`` (f32, TF32 off, seeded init) at (a) molecule
    (graph MSE, exact flat triplets; 10 steps at lr 2e-3 on one batch, the
    loss must fall), (b) full_graph_sm (node-mask MSE, the dense (E, 8)
    layout; flat equal to dense) and (c) minibatch_lg (seed MSE on a
    fanout-sampled subgraph, dense); at (a) and (b) one step's loss and
    gradients held against the port's CPU step, at each shape two runs of
    one step the same bits, K1-K6 no launch. Each batch built once on the
    host, its seconds printed (minibatch_lg's from ``minibatch``, the
    pending result of ``start_minibatch_host``, when given, beside the
    seconds this phase waited for it). ogb_products is printed as
    skipped. One ``dimenet_<shape>`` line a shape, then ``dimenet``."""
    t0 = time.perf_counter()
    rows = {}

    from repro_torch.configs.base import SHAPES_GNN

    cfg = dimenet_config("molecule")
    host, secs = molecule_host()
    n_learn, lr = DIMENET_LEARN
    row, state, batch = dimenet_shape(
        torch, "molecule", cfg, host, n_graphs=SHAPES_GNN["molecule"].n_graphs,
        cpu=True, steps=n_learn, lr=lr)
    losses = row["train"]["losses"]
    require(losses[-1] < losses[0], f"dimenet molecule: no learning {losses}")
    rows["molecule"] = dict(row, host_s=secs)
    emit("dimenet_molecule", **rows["molecule"])
    del state, batch

    cfg = dimenet_config("full_graph_sm")
    host, flat, dense, secs = full_graph_host(cfg)
    host["t_in_dense"], host["t_mask_dense"] = dense
    row, state, batch = dimenet_shape(
        torch, "full_graph_sm", cfg, host, cpu=True, steps=DIMENET_STEPS,
        lr=1e-4)
    row["flat_vs_dense"] = flat_vs_dense(torch, cfg, state["params"], batch,
                                         flat_triplets(*flat))
    require(row["flat_vs_dense"]["within_tol"],
            f"dimenet full_graph_sm: flat vs dense {row['flat_vs_dense']}")
    rows["full_graph_sm"] = dict(row, host_s=secs)
    emit("dimenet_full_graph_sm", **rows["full_graph_sm"])
    del state, batch

    cfg = dimenet_config("minibatch_lg")
    t1 = time.perf_counter()
    host, dense, secs, sampled = (
        minibatch_host(cfg, SHAPES_GNN["minibatch_lg"]) if minibatch is None
        else minibatch.get())
    secs["waited_s"] = time.perf_counter() - t1
    host["t_in_dense"], host["t_mask_dense"] = dense
    row, state, batch = dimenet_shape(
        torch, "minibatch_lg", cfg, host, cpu=False, steps=DIMENET_STEPS,
        lr=1e-4)
    rows["minibatch_lg"] = dict(row, host_s=secs, sampled=sampled)
    emit("dimenet_minibatch_lg", **rows["minibatch_lg"])
    del state, batch, host
    torch.cuda.empty_cache()

    seconds = time.perf_counter() - t0
    emit("dimenet", seconds=seconds, skipped={"ogb_products": OGB_SKIP},
         median_step_ms={k: r["train"]["median_step_ms"]
                         for k, r in rows.items()},
         peak_gib={k: r["train"]["peak_gib"] for k, r in rows.items()},
         two_runs_same_bits={k: r["grads"]["two_runs_same_bits"]
                             for k, r in rows.items()},
         edges_cut=rows["minibatch_lg"]["sampled"]["edges_cut"])
    return {"seconds": seconds}


# --------------------------------------------------------------------------
# 16. the dry run
# --------------------------------------------------------------------------

# (a) dryrun.main an arch at a time (the CLI's --arch), longest first, in
# this many spawned processes beside the card's phases from the xlmr phase
# on (after the eval phase, whose heads run in processes of their own)
DRYRUN_WORKERS = 3
DRYRUN_ARCHS = ("gemma2_27b", "phi3_5_moe", "moonshot_v1_16b", "phi3_mini",
                "llama3_2_3b", "dimenet", "splade_bert", "splade_xlmr",
                "dlrm_mlperf", "xdeepfm", "dien", "wide_deep")
DRYRUN_WAIT_S = 600        # the longest the phase waits for (a)
# (b) a step of each kind on the card: (name, arch, shape, rows, seq_len);
# rows 0 keeps the published batch. llama's prefill_32k (32 x 32768) and
# decode_32k (128 sequences at a 32768 cache) need 118 and 492 GB
# (their estimates), so each runs one sequence, the prefill at 4096
DRYRUN_MEASURED = (
    ("xlmr_train_16", "splade_xlmr", "train_16", 0, 0),
    ("bert_table3_384", "splade_bert", "table3_384", 0, 0),
    ("llama_prefill_1x4096", "llama3_2_3b", "prefill_32k", 1, 4096),
    ("llama_decode_1x32768", "llama3_2_3b", "decode_32k", 1, 0),
    ("dimenet_molecule", "dimenet", "molecule", 0, 0),
    ("wide_deep_train_batch", "wide_deep", "train_batch", 0, 0),
    ("wide_deep_serve_p99", "wide_deep", "serve_p99", 0, 0),
    ("wide_deep_retrieval_cand", "wide_deep", "retrieval_cand", 0, 0),
)
# a measured peak against its estimate: within the larger of these
DRYRUN_TOL = (0.10, 256 * 2**20)


def _hide_cuda():
    """The dry run's workers: no CUDA context of theirs on the card, one
    CPU thread each."""
    import os

    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    os.environ["OMP_NUM_THREADS"] = "1"


def dryrun_worker(argv, log):
    """``dryrun.main(argv)`` with its lines sent to ``log``: the records
    (``--json``), the exit code and the seconds."""
    import tempfile

    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/records.json"
        with open(log, "w") as f, contextlib.redirect_stdout(f), \
                contextlib.redirect_stderr(f):
            rc = dryrun.main([*argv, "--json", out])
        records = json.loads(Path(out).read_text()) if Path(out).exists() \
            else []
    return {"argv": argv, "rc": rc, "records": records,
            "seconds": time.perf_counter() - t0}


def dryrun_estimates(cells):
    """(b)'s estimates: ``dryrun.run_cell`` of each ``DRYRUN_MEASURED``
    cell at its cut."""
    from repro_torch.configs.specs import cell_spec, with_rows
    from repro_torch.launch import dryrun

    out = {}
    for name, arch, shape, rows, seq in cells:
        cell = cell_spec(arch, shape)
        if rows:
            cell = with_rows(cell, rows, seq)
        out[name] = dryrun.run_cell(arch, shape, cell=cell, verbose=False)
    return out


def start_dryrun():
    """(a) and (b)'s estimates in ``DRYRUN_WORKERS`` spawned processes
    that cannot see the card, started now: the pending results, for
    ``phase_dryrun``. The processes are terminated when the script
    exits."""
    import atexit
    import multiprocessing
    import tempfile

    logs = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    pool = multiprocessing.get_context("spawn").Pool(
        DRYRUN_WORKERS, initializer=_hide_cuda)
    atexit.register(pool.terminate)
    pending = {"pool": pool,
               "estimates": pool.apply_async(dryrun_estimates,
                                             (DRYRUN_MEASURED,))}
    for arch in DRYRUN_ARCHS:
        pending[arch] = pool.apply_async(
            dryrun_worker, (["--arch", arch], str(logs / f"{arch}.log")))
    return pending


def dryrun_line(rec):
    """A cell's printed line."""
    if rec["status"] != "ok":
        return {k: rec.get(k) for k in ("arch", "shape", "status", "reason",
                                        "error")}
    mem = rec["memory_analysis"]
    return {"cell": f"{rec['arch']}/{rec['shape']}",
            "kind": rec["step_kind"], "n_micro": rec["n_micro"],
            "flops_by_dtype": rec["flops_by_dtype"],
            "bytes": rec["hbm_bytes_per_device"],
            "peak_estimate_bytes": mem["peak_estimate_bytes"],
            "fits": rec["fits_one_card"],
            "limit": rec["memory_limit_source"],
            "compute_s": rec["compute_s"], "memory_s": rec["memory_s"],
            "roofline_s": max(rec["compute_s"], rec["memory_s"]),
            "bottleneck": rec["bottleneck"],
            "model_flops": rec["model_flops_per_device"],
            "useful_ratio": rec["useful_ratio"],
            "kernel_costs": rec["kernel_costs"], "pass_s": rec["compile_s"]}


def dryrun_step(torch, cfg, cell, first, base):
    """(b) One cell's step on the card on ``first`` (its state or params,
    allocated above ``base``): a warm-up call, then the measured one."""
    import gc

    from repro_torch.configs.specs import random_batch
    from repro_torch.launch.steps import build_cell_step
    from repro_torch.tree import tree_leaves

    k1, _, _ = head_and_impact_modules()
    step = build_cell_step(cfg, cell)
    batch = random_batch(cell, cfg, torch.Generator(device="cuda")
                         .manual_seed(1), "cuda")
    out = step(first, batch)
    torch.cuda.synchronize()
    del out
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with plain_guard(**eval_plains()) as plain_on_cuda:
        start.record()
        out = step(first, batch)
        end.record()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    row = {"ms": start.elapsed_time(end), "peak_bytes": peak,
           "launches": read_launches(),
           "k1_paths": dict(k1.sparton_forward.path_launches),
           "plain_on_cuda": sorted(set(plain_on_cuda)),
           "finite": all(bool(torch.isfinite(t.float()).all())
                         for t in tree_leaves(out)
                         if isinstance(t, torch.Tensor)
                         and t.is_floating_point())}
    del out, batch
    return row


def phase_dryrun(torch, pending=None):
    """(a) the dry run's records, (b) a step of each kind on the card
    held against its estimate (see the module's docstring)."""
    import dataclasses
    import gc

    from repro_torch.configs.specs import cell_spec, with_rows
    from repro_torch.launch.dryrun import step_inputs
    from repro_torch.launch.steps import arch_config_for_cell

    pending = dict(pending or start_dryrun())
    pool = pending.pop("pool")
    t0 = time.perf_counter()
    estimates = pending.pop("estimates").get(DRYRUN_WAIT_S)
    total = torch.cuda.get_device_properties(0).total_memory
    measured, launches = {}, {}
    first_of = {}   # one state or params an (arch, kind of first argument)
    for name, arch, shape, rows, seq in DRYRUN_MEASURED:
        cell = cell_spec(arch, shape)
        if rows:
            cell = with_rows(cell, rows, seq)
        cfg = arch_config_for_cell(arch, cell)
        key = (arch, cell.step_kind.endswith("_train"), cfg)
        if key not in first_of:
            first = None
            first_of.clear()
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            first_of[key] = (step_inputs(
                cfg, cell, torch.Generator(device="cuda").manual_seed(0),
                "cuda"), base)
        first, base = first_of[key]
        row = dryrun_step(torch, cfg, cell, first, base)
        est = estimates[name]
        want = est["memory_analysis"]["peak_estimate_bytes"]
        tol = max(DRYRUN_TOL[0] * want, DRYRUN_TOL[1])
        roof = max(est["compute_s"], est["memory_s"])
        launches[name] = row.pop("launches")
        measured[name] = {
            "cell": f"{arch}/{shape}", "kind": cell.step_kind,
            "batch": {k: list(v.shape) for k, v in cell.batch.items()},
            **row, "peak_estimate_bytes": want,
            "peak_over_estimate": row["peak_bytes"] / want,
            "within_tol": abs(row["peak_bytes"] - want) <= tol,
            "roofline_ms": 1e3 * roof, "bottleneck": est["bottleneck"],
            "ms_over_roofline": row["ms"] / (1e3 * roof),
            "launches": launches[name]}
        emit("dryrun_step", name=name, **measured[name])
    del first_of, first
    gc.collect()
    torch.cuda.empty_cache()

    runs = [pending[arch].get(max(1.0, DRYRUN_WAIT_S - (
        time.perf_counter() - t0))) for arch in DRYRUN_ARCHS]
    pool.terminate()
    pool.join()
    records = [rec for run in runs for rec in run["records"]]
    for rec in records:
        line = dryrun_line(rec)
        if rec["status"] == "ok":
            line["fits_this_card"] = line["peak_estimate_bytes"] <= total
        emit("dryrun_cell", **line)
    status = {s: sum(r["status"] == s for r in records)
              for s in ("ok", "skipped", "FAILED")}
    emit("dryrun", status=status, total_memory=total,
         runs={" ".join(r["argv"]): {"rc": r["rc"], "seconds": r["seconds"]}
               for r in runs},
         measured={name: {k: m[k] for k in (
             "kind", "peak_bytes", "peak_estimate_bytes",
             "peak_over_estimate", "within_tol", "ms", "ms_over_roofline")}
             for name, m in measured.items()})
    require(all(r["rc"] == 0 for r in runs)
            and status == {"ok": 41, "skipped": 4, "FAILED": 0},
            f"dryrun: the matrix's records {status}, exit codes "
            f"{[r['rc'] for r in runs]}")
    kinds = {m["kind"] for m in measured.values()}
    require(len(kinds) == 7, f"dryrun: step kinds measured {sorted(kinds)}")
    for name, m in measured.items():
        require(m["within_tol"], f"dryrun {name}: peak {m['peak_bytes']} "
                f"against the estimate {m['peak_estimate_bytes']}")
        require(m["finite"], f"dryrun {name}: non-finite outputs")
        require(not m["plain_on_cuda"], f"dryrun {name}: plain versions "
                f"ran on CUDA tensors: {m['plain_on_cuda']}")
        n = m["launches"]
        if m["kind"].startswith("lsr_"):
            k1_calls = (2 * cell_spec(*m["cell"].split("/")).n_micro
                        if m["kind"] == "lsr_train" else 1)
            want = {"sparton_fwd": k1_calls,
                    "sparton_bwd_dh": k1_calls if m["kind"] == "lsr_train"
                    else 0}
            want["sparton_bwd_de"] = want["sparton_bwd_dh"]
            require({k: n[k] for k in want} == want
                    and m["k1_paths"]["tma"] == k1_calls,
                    f"dryrun {name}: launches {n}, paths {m['k1_paths']}, "
                    f"expected {want} on tma")
        else:
            require(not any(n.values()), f"dryrun {name}: launches {n}")
    return {"launches": launches,
            "k1_paths": {name: m["k1_paths"] for name, m in measured.items()
                         if m["kind"].startswith("lsr_")}}


# --------------------------------------------------------------------------
# 17. the vocab-sharded head and LSR training over a (data, model) mesh
# --------------------------------------------------------------------------

SHARDED_RANKS = 2
# (data, model) meshes of the two ranks: (a) the vocabulary split in two
# (V_local 125001), (b) the batch split in two
SHARDED_MESHES = {"model": (1, 2), "data": (2, 1)}
SHARDED_PREFILL = (64, 16)    # the serve phase's index batch
SHARDED_STEPS = 1             # (d)'s timed train_16 steps after a warm-up
SHARDED_LR = 2e-4
SHARDED_LOSS_RTOL = 1e-4
SHARDED_TIMEOUT_S = 600       # a rank that hangs is killed after this
SHARDED_NOTE = ("two gloo ranks share one card: each collective is staged "
                "through the host, and the ranks' kernels take turns on "
                "the card; these numbers measure no multi-card scaling")


def bits_over_ranks(torch, mesh, tree):
    """Whether every leaf of ``tree`` is the same bits on every rank of
    ``mesh``: each compared with rank 0's, broadcast."""
    from repro_torch.collectives import broadcast
    from repro_torch.tree import tree_leaves

    ints = {4: torch.int32, 2: torch.int16, 1: torch.int8}
    same = True
    for leaf in tree_leaves(tree):
        first = broadcast(leaf, mesh.axis_names, mesh)
        same &= torch.equal(leaf.contiguous().view(ints[leaf.element_size()]),
                            first.view(ints[leaf.element_size()]))
    return bool(same)


def checksum(torch, tree):
    """Two int64 sums per leaf of its 32-bit words (one position-weighted):
    tells the seeded states of two processes apart."""
    from repro_torch.tree import tree_leaves

    sums = []
    for leaf in tree_leaves(tree):
        w = leaf.contiguous().view(torch.int32).view(-1).long()
        pos = torch.arange(w.numel(), device=w.device) % 65521 + 1
        sums += [int(w.sum()), int((w * pos).sum())]
    return sums


def sharded_prefill(torch, cfg, mesh, params, root, rank):
    """(a) ``build_lsr_prefill_step`` with the mesh at SHARDED_PREFILL: K1
    once, on "tma", at V_local; this rank's Y block saved for the
    parent."""
    from repro_torch.kernels import sparton as k1
    from repro_torch.launch.steps import build_lsr_prefill_step

    B, S = SHARDED_PREFILL
    batch = train_batches(torch, B, S, 1, cfg.vocab_size)[0]
    serve = build_lsr_prefill_step(cfg, mesh, B)
    torch.cuda.synchronize()
    reset_launches()
    y = serve(params, {"tokens": batch["q_tokens"], "mask": batch["q_mask"]})
    torch.cuda.synchronize()
    launches = read_launches()
    paths = dict(k1.sparton_forward.path_launches)
    require(launches["sparton_fwd"] == 1 and paths["tma"] == 1,
            f"sharded prefill, rank {rank}: K1 launches {launches}, paths "
            f"{paths}; expected 1 on 'tma'")
    torch.save(y.cpu(), Path(root) / f"prefill_y_{rank}.pt")
    return {"launches": launches, "k1_paths": paths,
            "y_block": list(y.shape)}


def sharded_train(torch, cfg, mesh, state, batch, root, rank, name):
    """(a)/(b) one step of ``build_lsr_train_step`` with the mesh, every
    rank holding the whole state: its loss, CUDA-event ms, collectives
    (``collectives.TALLY``), peak memory and K1-K3 launches (2 x n_micro
    each, K1 on "tma"); the parameters and the moments the same bits on
    both ranks; rank 0 saves the first moments for the parent. Returns
    the record and the state after the step."""
    from repro_torch import collectives
    from repro_torch.kernels import sparton as k1
    from repro_torch.launch.steps import build_lsr_train_step
    from repro_torch.tree import tree_items

    n_micro, pairs = 1, batch["q_tokens"].shape[0]
    step = build_lsr_train_step(cfg, mesh, n_micro=n_micro, n_pairs=pairs,
                                lr=SHARDED_LR)
    collectives.TALLY.reset(synchronize=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, metrics = step(state, batch)
    end.record()
    end.synchronize()
    launches = read_launches()
    paths = dict(k1.sparton_forward.path_launches)
    tally = collectives.TALLY.summary()
    want = 2 * n_micro
    require(all(launches[k] == want for k in
                ("sparton_fwd", "sparton_bwd_dh", "sparton_bwd_de"))
            and paths["tma"] == want,
            f"sharded train {name}, rank {rank}: launches {launches}, K1 "
            f"paths {paths}; expected {want} each on 'tma'")
    loss = float(metrics["loss"])
    require(np.isfinite(loss), f"sharded train {name}: loss {loss}")
    same = bits_over_ranks(torch, mesh, state["params"])
    require(same, f"sharded train {name}: the ranks' parameters differ")
    moments = bits_over_ranks(torch, mesh, state["opt"])
    require(moments, f"sharded train {name}: the ranks' moments differ")
    if rank == 0:
        torch.save({k: v.cpu() for k, v in
                    tree_items(state["opt"]["mu"]).items()},
                   Path(root) / f"mu_{name}.pt")
    row = {"step": 1, "timed": False, "loss": loss,
           "ms": start.elapsed_time(end),
           "collectives_ms": {k: v["ms"] for k, v in tally.items()},
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "params_same_bits": same}
    return {"n_micro": n_micro, "pairs": pairs, "steps": [row],
            "launches": launches, "k1_paths": paths, "collectives": tally,
            "moments_same_bits": moments}, state


def holders_agree(torch, mesh, specs, tree):
    """Whether every rank that holds a block of a leaf of ``tree`` (held by
    the spec tree ``specs``) holds the same bits: two int64 sums of each
    block's 32-bit words (one position-weighted), broadcast from the
    first rank of the axes its spec does not name, one broadcast for
    each set of such axes."""
    from repro_torch.collectives import broadcast
    from repro_torch.launch.sharding import map_specs, spec_axes

    groups = {}

    def add(spec, leaf):
        axes = tuple(a for a in mesh.axis_names
                     if a not in spec_axes(spec) and mesh.shape[a] > 1)
        if axes:
            w = leaf.contiguous().view(torch.int32).view(-1).long()
            pos = torch.arange(w.numel(), device=w.device) % 65521 + 1
            groups.setdefault(axes, []).append(
                torch.stack([w.sum(), (w * pos).sum()]))
    map_specs(add, specs, tree)
    same = True
    for axes, sums in groups.items():
        mine = torch.stack(sums)
        same &= torch.equal(mine, broadcast(mine, axes, mesh))
    return bool(same)


def sharded_zero(torch, cfg, mesh, state0, replicated, batches, rank, name):
    """(d) ``build_lsr_train_step(param_specs=, zero_specs=)`` on the state
    held by ``state_shardings(transformer_param_specs(cfg, mesh), ...)``
    (cut from the seeded ``state0`` by ``shard_state``): one warm-up and
    SHARDED_STEPS timed steps on ``batches``, the first (a)/(b)'s. Gates
    on the rank: its state bytes equal to the specs' count, K1-K3 2 x
    n_micro a step on "tma", every block the same bits on the ranks that
    hold it after each step. Returns each step's loss, CUDA-event ms,
    collectives and peak; the state bytes beside the replicated state's;
    and, after step 1, the params and the first moments gathered by
    ``gather_state`` against ``replicated`` ((a)/(b)'s state after their
    step on the same batch): each leaf's update (new minus initial
    params) relative to the replicated update's and each leaf's moments
    relative to the replicated ones, in norm, and whether the bits are
    equal. A gradient summed twice or scaled moves the moments, though
    not Adam's update."""
    from repro_torch import collectives
    from repro_torch.kernels import sparton as k1
    from repro_torch.launch import sharding
    from repro_torch.launch.steps import build_lsr_train_step
    from repro_torch.tree import tree_leaves

    specs = sharding.state_shardings(
        sharding.transformer_param_specs(cfg, mesh), state0["params"],
        "adamw", mesh)
    state = sharding.shard_state(mesh, specs, state0)
    held = sum(t.nbytes for t in tree_leaves(state)
               if isinstance(t, torch.Tensor))
    counted = sharding.state_nbytes(mesh, specs, state0)
    whole = sum(t.nbytes for t in tree_leaves(state0)
                if isinstance(t, torch.Tensor))
    require(held == counted, f"sharded zero {name}, rank {rank}: the state "
                             f"holds {held} bytes, the specs count {counted}")
    n_micro, pairs = 1, batches[0]["q_tokens"].shape[0]
    step = build_lsr_train_step(cfg, mesh, n_micro=n_micro, n_pairs=pairs,
                                lr=SHARDED_LR, param_specs=specs["params"],
                                zero_specs=specs["opt"]["mu"])
    rows = []
    for i, batch in enumerate(batches):
        collectives.TALLY.reset(synchronize=i > 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch)
        end.record()
        end.synchronize()
        launches = read_launches()
        paths = dict(k1.sparton_forward.path_launches)
        tally = collectives.TALLY.summary()
        want = 2 * n_micro
        if i == 0:
            against = against_replicated(torch, mesh, specs, state, state0,
                                         replicated)
        require(all(launches[k] == want for k in
                    ("sparton_fwd", "sparton_bwd_dh", "sparton_bwd_de"))
                and paths["tma"] == want,
                f"sharded zero {name}, rank {rank}, step {i + 1}: launches "
                f"{launches}, K1 paths {paths}; expected {want} each on "
                f"'tma'")
        loss = float(metrics["loss"])
        require(np.isfinite(loss), f"sharded zero {name}: loss {loss}")
        same = holders_agree(
            torch, mesh, {k: specs[k] for k in ("params", "opt")},
            {k: state[k] for k in ("params", "opt")})
        require(same, f"sharded zero {name}, step {i + 1}: ranks holding "
                      f"the same block differ")
        rows.append({"step": i + 1, "timed": i > 0, "loss": loss,
                     "ms": start.elapsed_time(end),
                     "collectives": tally,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "blocks_same_bits": same})
    return {"n_micro": n_micro, "pairs": pairs, "steps": rows,
            "launches": launches, "k1_paths": paths,
            "v_head": cfg.vocab_size // mesh.shape["model"]
            if cfg.vocab_size % mesh.shape["model"] == 0
            else cfg.vocab_size,
            "state_bytes": held, "spec_bytes": counted,
            "replicated_bytes": whole, "state_gb": held / 1e9,
            "replicated_gb": whole / 1e9, **against}


def against_replicated(torch, mesh, specs, state, state0, replicated):
    """``sharded_zero``'s comparison: the params and the first moments of
    ``state`` (held by ``specs``) gathered, against ``replicated``'s after
    the same step from ``state0``: each leaf's update relative to the
    replicated update's and each leaf's moments relative to the
    replicated ones, in norm, the worst of each, and whether all the bits
    are equal."""
    from repro_torch.launch import sharding
    from repro_torch.tree import tree_items

    def rel(got, want):
        return {k: float((g - want[k]).norm()
                         / want[k].norm().clamp_min(1e-30))
                for k, g in got.items()}

    def equal(got, want):
        return all(torch.equal(g, want[k]) for k, g in got.items())

    p0 = tree_items(state0["params"])
    params = tree_items(sharding.gather_state(mesh, specs["params"],
                                              state["params"]))
    ref = tree_items(replicated["params"])
    update = rel({k: p - p0[k] for k, p in params.items()},
                 {k: r - p0[k] for k, r in ref.items()})
    mu = tree_items(sharding.gather_state(mesh, specs["opt"]["mu"],
                                          state["opt"]["mu"]))
    ref_mu = tree_items(replicated["opt"]["mu"])
    moments = rel(mu, ref_mu)
    up, mw = max(update, key=update.get), max(moments, key=moments.get)
    return {"update_rel_diff": {"max": update[up], "leaf": up,
                                "per_leaf": update},
            "mu_rel_diff": {"max": moments[mw], "leaf": mw,
                            "per_leaf": moments},
            "params_bit_equal_replicated": equal(params, ref),
            "mu_bit_equal_replicated": equal(mu, ref_mu)}


def sharded_compressed(torch, cfg, mesh, params, batches):
    """(c) ``compressed_allreduce`` over ``data`` on each rank's share of
    a step's gradients (``sharded_lsr_loss`` on the data-split batch), two
    calls with the residual carried: within the int8 bound of the plain
    mean of ``gradient + residual``, the same bits on both ranks."""
    from repro_torch import collectives
    from repro_torch.launch.steps import sharded_lsr_loss, value_and_grad
    from repro_torch.optim.compression import _flatten, compressed_allreduce

    pairs = batches[0]["q_tokens"].shape[0]
    grad_fn = value_and_grad(sharded_lsr_loss(cfg, mesh, pairs))
    n = mesh.shape["data"]
    residual, calls = None, []
    for batch in batches[:2]:
        _, grads = grad_fn(params, batch)
        flat, _ = _flatten(grads)
        size = flat.numel()
        corrected = torch.nn.functional.pad(flat, (0, (-size) % n))
        if residual is not None:
            corrected += residual
        plain = collectives.pmean(corrected, "data", mesh)[:size]
        bound = float(collectives.pmean(corrected.abs().max(), "data",
                                        mesh)) / 127
        del flat, corrected
        collectives.TALLY.reset(synchronize=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, residual = compressed_allreduce(grads, residual, "data", mesh)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        got, _ = _flatten(mean)
        err = float((got - plain).abs().max())
        same = bits_over_ranks(torch, mesh, mean)
        require(err <= bound * (1 + 1e-5) and same,
                f"compressed_allreduce: max error {err} against the int8 "
                f"bound {bound}, same bits on both ranks {same}")
        calls.append({"elements": size, "max_abs_err": err,
                      "int8_bound": bound, "ms": ms,
                      "collectives": collectives.TALLY.summary(),
                      "same_bits": same})
        del grads, mean, got, plain
        torch.cuda.empty_cache()
    return calls


def sharded_rank(rank, root):
    """One rank of the sharded phase (a gloo world of SHARDED_RANKS on the
    one card): splade_xlmr's seeded state on each mesh of SHARDED_MESHES,
    (a) the prefill and train steps on (1, 2), (b) the train steps and (c)
    ``compressed_allreduce`` on (2, 1), (d) on each mesh the train steps
    on the state held by the specs (``sharded_zero``); no plain version of
    K1-K3 on the card."""
    import torch

    from repro_torch.configs.splade_xlmr import CONFIG, SHAPES
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import init_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shape = SHAPES["train_16"]
    batches = train_batches(torch, shape.global_batch, shape.seq_len,
                            1 + SHARDED_STEPS, CONFIG.vocab_size)
    out = {}
    with plain_guard(**eval_plains()) as plain_on_cuda:
        for name, mesh_shape in SHARDED_MESHES.items():
            mesh = Mesh(mesh_shape, ("data", "model"))
            state = init_state("splade_xlmr", torch.Generator(
                device="cuda").manual_seed(0))
            rec = {"coords": mesh.coords, "device": str(mesh.device),
                   "init_checksum": checksum(torch, state["params"])}
            if name == "model":
                rec["prefill"] = sharded_prefill(torch, CONFIG, mesh,
                                                 state["params"], root, rank)
            else:
                rec["compressed"] = sharded_compressed(
                    torch, CONFIG, mesh, state["params"], batches)
            rec["train"], final = sharded_train(torch, CONFIG, mesh, state,
                                                batches[0], root, rank, name)
            rec["zero"] = sharded_zero(torch, CONFIG, mesh, state, final,
                                       batches, rank, name)
            rec["zero"]["replicated_peak_gib"] = max(
                r["peak_gib"] for r in rec["train"]["steps"])
            out[name] = rec
            del state, final
            torch.cuda.empty_cache()
    require(not plain_on_cuda, f"sharded, rank {rank}: plain versions ran "
                               f"on CUDA tensors: {sorted(set(plain_on_cuda))}")
    return out


def sharded_timing(torch, E, b, shape):
    """K1, K2 and K3 at train_16 (16 x 256, padded as lsr_pair_batches
    pads) on rank 1's vocab shard of xlmr's head weights (rows 125001 on:
    b's base 4-byte aligned, every (B, V_local) row 500004 bytes) and on
    the whole vocabulary, as ``xlmr_timing`` times them (random bf16 H
    from seed 21, a cotangent of scale 1e-2, the random-init routing)."""
    from repro_torch.kernels.sparton import sparton_forward

    B, S = shape.global_batch, shape.seq_len
    V_local = E.shape[0] // SHARDED_RANKS
    rows = {}
    for where, (E_, b_) in (("shard", (E[V_local:], b[V_local:])),
                            ("whole", (E, b))):
        g = torch.Generator(device="cuda").manual_seed(21)
        H = torch.randn((B, S, E.shape[1]), generator=g,
                        device="cuda").to(torch.bfloat16)
        lens = torch.randint(int(0.3 * S), S + 1, (B, 1), generator=g,
                             device="cuda")
        mask = (torch.arange(S, device="cuda") < lens).int()
        k1_row = time_k1(torch, H, E_, b_, mask, reps=3, plain_reps=1)
        y, i_max = sparton_forward(H, E_, b_, mask)
        dy = torch.randn(y.shape, generator=g, device="cuda") * 1e-2
        bwd = time_bwd(torch, H, E_, b_, mask, dy, y, i_max, reps=3,
                       plain_reps=1, library="sparse")
        rows[where] = {"k1": k1_row, "dh": bwd["dh"], "de": bwd["de"],
                       "b_base_mod16": b_.data_ptr() % 16,
                       "row_bytes": 4 * E_.shape[0]}
        del H, y, i_max, dy
        torch.cuda.empty_cache()
    return rows


def vocab_order_control(torch, cfg, state, batch, ref_mu):
    """The unsharded step on ``state`` and ``batch`` with the vocabulary
    in another order (the tied E's and b's rows permuted, the tokens
    renamed to match): the same function, with every f32 sum over V (the
    scores, the regularizers, K2's dH) in another order, as the model
    mesh reorders them. Returns its step-1 loss and each leaf's relative
    difference of the first moments from ``ref_mu`` (E's and b's rows put
    back in order)."""
    from repro_torch.launch.steps import build_lsr_train_step
    from repro_torch.tree import tree_items

    require(cfg.tie_embeddings, "vocab_order_control permutes a tied E")
    perm = torch.randperm(cfg.vocab_size, device="cuda", generator=torch.
                          Generator(device="cuda").manual_seed(5))
    inv = torch.argsort(perm)
    params = {**state["params"], "embed": state["params"]["embed"][perm],
              "lm_head": {"b": state["params"]["lm_head"]["b"][perm]}}
    tokens = {k: inv[v.long()].to(v.dtype) for k, v in batch.items()
              if k.endswith("tokens")}
    new, metrics = build_lsr_train_step(cfg, lr=SHARDED_LR)(
        {**state, "params": params}, {**batch, **tokens})
    mu = tree_items(new["opt"]["mu"])
    mu["embed"], mu["lm_head/b"] = mu["embed"][inv], mu["lm_head/b"][inv]
    per = {k: float((mu[k] - ref_mu[k]).norm()
                    / ref_mu[k].norm().clamp_min(1e-30)) for k in ref_mu}
    return float(metrics["loss"]), per


def phase_sharded(torch, grad_limit=None):
    """The vocab-sharded head and LSR training on SHARDED_RANKS gloo
    ranks sharing the card, splade_xlmr at full width: the parent computes
    the references with the port's unsharded steps on the same seeded
    state, spawns the ranks (``sharded_rank``) and holds (a) the gathered
    prefill Y to K1_TOL of the unsharded one, and on each mesh the step-1
    loss to SHARDED_LOSS_RTOL and the first moments per leaf to the
    gradient check's rule: GRAD_RATIO x the larger of its bf16 controls
    (``grad_limit``, the xlmr phase's limit, measured here when the phase
    runs alone) and of ``vocab_order_control`` at this phase's shape (the
    order of the sums over V is what the model mesh changes: at train_16
    InfoNCE's scores sum 250002 products each); (d) on each mesh the
    step on the state held by the specs: step 1's loss to
    SHARDED_LOSS_RTOL, each leaf's update and first moments after step 1
    to the same limit as the moments against (a)/(b)'s
    (``sharded_zero``); then K1-K3 timed at
    V_local and at the whole vocabulary (``sharded_timing``)."""
    import dataclasses
    import tempfile

    from repro_torch.configs.splade_xlmr import CONFIG, SHAPES
    from repro_torch.launch.mesh import spawn_world
    from repro_torch.launch.steps import (build_lsr_prefill_step,
                                          build_lsr_train_step, init_state)
    from repro_torch.tree import tree_items

    t0 = time.perf_counter()
    if grad_limit is None:
        grad_limit = grad_check(torch, dataclasses.replace(
            CONFIG, remat=False), XLMR_GRAD_CHECK)["bfloat16"]["limit"]
    shape = SHAPES["train_16"]
    state = init_state("splade_xlmr",
                       torch.Generator(device="cuda").manual_seed(0))
    init_sum = checksum(torch, state["params"])
    B, S = SHARDED_PREFILL
    pre = train_batches(torch, B, S, 1, CONFIG.vocab_size)[0]
    y_ref = build_lsr_prefill_step(CONFIG, None, B)(
        state["params"], {"tokens": pre["q_tokens"], "mask": pre["q_mask"]})
    batch = train_batches(torch, shape.global_batch, shape.seq_len, 1,
                          CONFIG.vocab_size)[0]
    new, metrics = build_lsr_train_step(CONFIG, lr=SHARDED_LR)(state, batch)
    ref_loss, ref_mu = float(metrics["loss"]), tree_items(new["opt"]["mu"])
    del new
    control_loss, control = vocab_order_control(torch, CONFIG, state, batch,
                                                ref_mu)
    mu_limit = max(grad_limit, GRAD_RATIO * max(control.values()))
    E16 = state["params"]["embed"].to(torch.bfloat16)   # tied: the head's E
    b = state["params"]["lm_head"]["b"].clone()
    del state, batch
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as root:
        t1 = time.perf_counter()
        ranks = spawn_world(sharded_rank, SHARDED_RANKS, backend="gloo",
                            root=root, args=(root,),
                            timeout=SHARDED_TIMEOUT_S)
        ranks_s = time.perf_counter() - t1
        for r, out in enumerate(ranks):
            for name in SHARDED_MESHES:
                require(out[name]["init_checksum"] == init_sum,
                        f"rank {r} ({name}): the seeded state differs from "
                        f"the parent's")
        blocks = [torch.load(Path(root) / f"prefill_y_{r}.pt")
                  for r in range(SHARDED_RANKS)]
        y = torch.cat(blocks, dim=1).cuda()
        err = (y - y_ref).abs()
        prefill = {"shape": [B, S], "y_blocks": [list(t.shape)
                                                 for t in blocks],
                   "max_abs_diff": float(err.max()),
                   "bit_identical": bool(torch.equal(y, y_ref)),
                   "within_k1_tol": bool((err <= K1_TOL + K1_TOL
                                          * y_ref.abs()).all())}
        failed = [] if prefill["within_k1_tol"] else [
            f"sharded prefill: gathered Y differs from the unsharded "
            f"prefill by {prefill['max_abs_diff']}"]
        del y, y_ref, blocks, err
        gates = {}
        for name in SHARDED_MESHES:
            mu = torch.load(Path(root) / f"mu_{name}.pt")
            per = {k: float((mu[k].cuda() - ref_mu[k]).norm()
                            / ref_mu[k].norm().clamp_min(1e-30))
                   for k in ref_mu}
            worst = max(per, key=per.get)
            losses = [out[name]["train"]["steps"][0]["loss"]
                      for out in ranks]
            rel = max(abs(l_ - ref_loss) / abs(ref_loss) for l_ in losses)
            gates[name] = {"step1_loss": losses, "unsharded_loss": ref_loss,
                           "loss_rel_diff": rel,
                           "mu_rel_diff": {"max": per[worst], "leaf": worst,
                                           "per_leaf": per},
                           "mu_limit": mu_limit}
            if rel > SHARDED_LOSS_RTOL:
                failed.append(f"sharded {name}: step-1 loss {losses} vs the "
                              f"unsharded {ref_loss}")
            if per[worst] > mu_limit:
                failed.append(f"sharded {name}: first moments of {worst} "
                              f"differ by {per[worst]} (relative), above "
                              f"{mu_limit}")
            del mu
            zero = [out[name]["zero"] for out in ranks]
            z_losses = [z["steps"][0]["loss"] for z in zero]
            z_rel = max(abs(l_ - ref_loss) / abs(ref_loss) for l_ in z_losses)
            z_upd = max(z["update_rel_diff"]["max"] for z in zero)
            z_mu = max(z["mu_rel_diff"]["max"] for z in zero)
            gates[f"zero_{name}"] = {
                "step1_loss": z_losses, "loss_rel_diff": z_rel,
                "update_rel_diff_max": z_upd,
                "update_rel_diff_leaf": zero[0]["update_rel_diff"]["leaf"],
                "mu_rel_diff_max": z_mu,
                "mu_rel_diff_leaf": zero[0]["mu_rel_diff"]["leaf"],
                "params_bit_equal_replicated": [
                    z["params_bit_equal_replicated"] for z in zero],
                "mu_bit_equal_replicated": [
                    z["mu_bit_equal_replicated"] for z in zero],
                "state_gb": [z["state_gb"] for z in zero],
                "replicated_gb": zero[0]["replicated_gb"],
                "peak_gib": [max(r["peak_gib"] for r in z["steps"])
                             for z in zero],
                "replicated_peak_gib": [z["replicated_peak_gib"]
                                        for z in zero],
                "limit": mu_limit}
            if z_rel > SHARDED_LOSS_RTOL:
                failed.append(f"sharded zero {name}: step-1 loss {z_losses} "
                              f"vs the unsharded {ref_loss}")
            if z_upd > mu_limit:
                failed.append(f"sharded zero {name}: the params' update "
                              f"differs from the replicated step's by "
                              f"{z_upd} (relative), above {mu_limit}")
            if z_mu > mu_limit:
                failed.append(f"sharded zero {name}: the first moments "
                              f"differ from the replicated step's by "
                              f"{z_mu} (relative), above {mu_limit}")
    del ref_mu
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    timing = sharded_timing(torch, E16, b, shape)
    timing_s = time.perf_counter() - t2
    del E16, b
    torch.cuda.empty_cache()
    launches = {}
    for r, out in enumerate(ranks):
        launches[f"rank{r}_prefill"] = out["model"]["prefill"]["launches"]
        for name in SHARDED_MESHES:
            launches[f"rank{r}_train_{name}"] = \
                out[name]["train"]["launches"]
            launches[f"rank{r}_zero_{name}"] = out[name]["zero"]["launches"]
    seconds = time.perf_counter() - t0
    emit("sharded", note=SHARDED_NOTE, ranks=SHARDED_RANKS,
         backend="gloo", config=CONFIG.name, meshes=SHARDED_MESHES,
         prefill=prefill, gates=gates,
         controls={"xlmr_grad_check_limit": grad_limit,
                   "vocab_order": {"loss": control_loss,
                                   "loss_rel_diff": abs(control_loss
                                                        - ref_loss)
                                   / abs(ref_loss),
                                   "mu_rel_diff": control},
                   "mu_limit": mu_limit},
         per_rank=[{name: {"coords": out[name]["coords"],
                           "device": out[name]["device"],
                           **{k: v for k, v in out[name].items()
                              if k in ("prefill", "train", "compressed",
                                       "zero")}}
                    for name in SHARDED_MESHES} for out in ranks],
         timing=timing, seconds={"total": seconds, "references": ref_s,
                                 "ranks": ranks_s, "timing": timing_s})
    require(not failed, "; ".join(failed))
    return {"launches": launches, "timing": timing, "seconds": seconds}


# --------------------------------------------------------------------------
# 18. the sharded index engines (doc, term and 2D) at splade_xlmr
# --------------------------------------------------------------------------

SE_SHARDS = (2, 4)             # one-process shard counts
SE_PRUNE = {"prune_margin": 0.5, "candidates": 256}
SE_INDEXES = {  # name: (kind, shards or grid); each searched exact and pruned
    "sharded_2": ("sharded", 2), "sharded_4": ("sharded", 4),
    "term_2": ("term_sharded", 2), "term_4": ("term_sharded", 4),
    "grid_2x2": ("shard2d", (2, 2))}
SE_RANKS = 4                   # one gloo world on a (2, 2) mesh, one card
SE_MESH = ((2, 2), ("data", "model"))
SE_WORLD = {  # case: (index, axis or 2D order, pruned)
    **{f"sharded_{ax}": ("sharded_2", ax, False) for ax in SE_MESH[1]},
    **{f"term_{ax}{tag}": ("term_2", ax, p) for ax in SE_MESH[1]
       for tag, p in (("", False), ("_pruned", True))},
    **{f"grid_{'_'.join(o)}{tag}": ("grid_2x2", o, p)
       for o in (("doc", "term"), ("term", "doc"))
       for tag, p in (("", False), ("_pruned", True))}}
SE_ENGINE = {"corpus": 4096, "batch": 64, "remove_frac": 0.05}
SE_CLI = {"corpus": 4096, "requests": 64, "index_batch": 64, "topk": 10,
          "runs": {"sharded": {"shards": 2}, "term_sharded": {"shards": 2},
                   "shard2d": {"shards": 4, "shard_axis": "2d"}}}
SE_REPS = 10                   # host-ms samples a search (median printed)
SE_TIMEOUT_S = 300             # a rank that hangs is killed after this
SE_NOTE = ("four gloo ranks share one card: each collective is staged "
           "through the host and the ranks take turns on the card; these "
           "numbers measure no multi-card scaling")


def se_ms(torch, fn, device):
    """``host_ms`` of ``fn`` (median of SE_REPS, synchronised) for an index
    on the card; ``(None, None)`` elsewhere, after one call."""
    if torch.device(device).type != "cuda":
        fn()
        return None, None
    return host_ms(torch, fn, n=SE_REPS)


def engine_rows(served, builder):
    """The xlmr engine's live base rows (compacted: every slot alive) and
    the serve phase's 8 and 64 served queries, as host numpy."""
    from repro_torch.retrieval.sparse_rep import device_get, stack_rows

    n = builder._base_n
    require(bool(builder._alive[:n].all()),
            "the xlmr engine's base holds tombstoned rows")
    v = builder._values[:n].copy()
    rows = {"dv": v, "di": builder._indices[:n].copy(),
            "dn": (v > 0).sum(axis=1).astype(np.int32)}
    res = served["res"]
    for tag, rep in (("q8", device_get(res["queries"])),
                     ("q64", stack_rows(res["served"]))):
        rows[tag + "v"], rows[tag + "i"], rows[tag + "n"] = (
            np.asarray(rep.values), np.asarray(rep.indices),
            np.asarray(rep.nnz))
    return rows


def se_rep(rows, tag):
    from repro_torch.retrieval.sparse_rep import SparseRep

    return SparseRep(rows[tag + "v"], rows[tag + "i"], rows[tag + "n"])


def se_build(name, docs, vocab, device):
    """The index of ``SE_INDEXES[name]`` on ``device`` (term and 2D with
    their forward rows, for the pruned composition)."""
    from repro_torch.retrieval.engine import (shard2d_index, shard_index,
                                              term_shard_index)

    kind, n = SE_INDEXES[name]
    if kind == "sharded":
        return shard_index(docs, vocab, n, device=device)
    if kind == "term_sharded":
        return term_shard_index(docs, vocab, n, keep_forward=True,
                                device=device)
    return shard2d_index(docs, vocab, *n, keep_forward=True, device=device)


def se_one_process(torch, rows, vocab, device="cuda"):
    """Each index of SE_INDEXES searched in this one process (``retrieve``,
    its sharded method; term and 2D also pruned at SE_PRUNE), at B 8 and
    64, against the unsharded index of the same rows: doc-sharded the same
    bits as ``impact``; term and 2D exact ids equal to ``impact``'s but at
    near ties, scores within SCORE_TOL; term pruned held so to the
    unsharded ``pruned`` at the same margin and candidates (a term's
    ceiling is its whole list's there too). A 2D cell's ceilings are its
    chunk's (tighter than the whole list's), so 2D pruned keeps other
    candidates at a margin: each score it returns must be its doc's exact
    score and its top-1 ``impact``'s but at a near tie. Each search's host
    ms (median of SE_REPS, synchronised) and each index's
    ``memory_bytes``."""
    from repro_torch.retrieval.index import build_inverted_index
    from repro_torch.retrieval.score import impact_scores, retrieve

    docs, k = se_rep(rows, "d"), SERVE["topk"]
    qs = {f"B{rows[t + 'v'].shape[0]}": se_rep(rows, t)
          for t in ("q8", "q64")}
    plain = build_inverted_index(docs, vocab, device=device)
    fwd = build_inverted_index(docs, vocab, keep_forward=True, device=device)
    want, scores = {}, {}
    for b, q in qs.items():
        scores[b] = impact_scores(q, plain)
        want[b] = {"exact": retrieve(q, plain, k, method="impact"),
                   "pruned": retrieve(q, fwd, k, method="pruned",
                                      **SE_PRUNE)}
    out = {"unsharded_memory_bytes": plain.memory_bytes(),
           "unsharded_forward_memory_bytes": fwd.memory_bytes(),
           "indexes": {}, "results": {}}
    failed = []
    for name, (method, _) in SE_INDEXES.items():
        index = se_build(name, docs, vocab, device)
        row = {"memory_bytes": index.memory_bytes(), "stats": index.stats(),
               "searches": {}}
        for mode in (("exact", "pruned") if method != "sharded"
                     else ("exact",)):
            kw = SE_PRUNE if mode == "pruned" else {}
            for b, q in qs.items():
                def search(q=q, kw=kw):
                    return retrieve(q, index, k, method=method, **kw)
                v, i = search()
                grid_pruned = method == "shard2d" and mode == "pruned"
                v_w, i_w = want[b]["exact" if grid_pruned else mode]
                hard, differ = ids_beyond_near_ties(torch, scores[b], i, i_w)
                err = float((v - v_w).abs().max())
                bits = bool(torch.equal(v, v_w) and torch.equal(i, i_w))
                exact = scores[b].gather(1, i.long())
                rescored = float((v - exact).abs().max())
                ms, spread = se_ms(torch, search, device)
                row["searches"][f"{mode}_{b}"] = {
                    "ids_differ": differ, "beyond_near_ties": hard,
                    "max_abs_err": err, "same_bits": bits,
                    "max_abs_err_vs_exact_scores": rescored,
                    "host_ms": ms, "host_ms_range": spread}
                out["results"][(name, mode, b)] = (v.cpu(), i.cpu())
                tol = SCORE_TOL * (1 + float(v_w.abs().max()))
                if method == "sharded" and not bits:
                    failed.append(f"{name} {b}: not the same bits as impact "
                                  f"(ids differ at {differ}, {err})")
                elif grid_pruned:
                    top1, _ = ids_beyond_near_ties(torch, scores[b],
                                                   i[:, :1], i_w[:, :1])
                    if top1 or rescored > tol:
                        failed.append(f"{name} pruned {b}: top-1 beyond a "
                                      f"near tie on {top1} rows, scores "
                                      f"{rescored} from the exact ones")
                elif hard or err > tol:
                    failed.append(f"{name} {mode} {b}: ids beyond near ties "
                                  f"{hard}, scores off by {err}")
        out["indexes"][name] = row
        del index
    require(not failed, "; ".join(failed))
    return out


def se_rank(rank, rows_path, vocab, device, dimenet=None, recsys=None):
    """One rank of the sharded_engine phase's world (SE_RANKS gloo ranks on
    the one card, a SE_MESH mesh): each SE_WORLD case at B 8 and 64, its
    results, its host ms (median of SE_REPS, synchronised) and its
    collectives (``collectives.TALLY`` over one call); then, given their
    arguments, the sharded_dimenet part (``sd_rank``) and the
    sharded_recsys part (``sr_rank``)."""
    import torch

    from repro_torch import collectives
    from repro_torch.kernels import impact_score as k45
    from repro_torch.kernels import sparton as k1
    from repro_torch.launch.mesh import Mesh
    from repro_torch.retrieval.engine import (ShardPlan, sharded_retrieve,
                                              term_sharded_retrieve)
    from repro_torch.retrieval.score import retrieve

    rows = dict(np.load(rows_path))
    docs, k = se_rep(rows, "d"), SERVE["topk"]
    qs = {f"B{rows[t + 'v'].shape[0]}": se_rep(rows, t)
          for t in ("q8", "q64")}
    mesh = Mesh(*SE_MESH, device=device)
    indexes = {name: se_build(name, docs, vocab, mesh.device)
               for name in {c[0] for c in SE_WORLD.values()}}
    out = {"coords": mesh.coords, "device": str(mesh.device), "cases": {}}
    with plain_guard(k1=(k1, "sparton_forward_plain"),
                     **k45_plains(k45)) as plain_on_cuda:
        for case, (name, axis, pruned) in SE_WORLD.items():
            index, kw = indexes[name], (SE_PRUNE if pruned else {})
            if name.startswith("grid"):
                plan = ShardPlan(2, 2, axis_order=axis)
                fn = lambda q: retrieve(q, index, k, method="shard2d",  # noqa: E731
                                        mesh=mesh, plan=plan, **kw)
            elif name.startswith("term"):
                fn = lambda q: term_sharded_retrieve(  # noqa: E731
                    q, index, k, mesh=mesh, axis_name=axis, **kw)
            else:
                fn = lambda q: sharded_retrieve(  # noqa: E731
                    q, index, k, mesh=mesh, axis_name=axis)
            for b, q in qs.items():
                collectives.TALLY.reset(synchronize=True)
                v, i = fn(q)
                tally = collectives.TALLY.summary()
                ms, spread = se_ms(torch, lambda: fn(q), device)
                out["cases"][(case, b)] = {
                    "v": v.cpu().numpy(), "i": i.cpu().numpy(),
                    "host_ms": ms, "host_ms_range": spread,
                    "collectives": tally}
    require(not plain_on_cuda, f"sharded_engine, rank {rank}: plain "
                               f"versions ran on CUDA tensors")
    if dimenet is not None:   # the sharded_dimenet phase, in this world
        out["sharded_dimenet"] = sd_rank(torch, rank, mesh, *dimenet)
    if recsys is not None:    # the sharded_recsys part, in this world
        out["sharded_recsys"] = sr_rank(torch, rank, mesh, *recsys)
    return out


def se_world(torch, rows, vocab, one, device="cuda", dimenet=None,
             recsys=None):
    """SE_RANKS gloo ranks sharing the card (``se_rank``), each held to the
    one-process result of its index (``one``): ids equal and, every psum
    here adding two partials, the same bits; every rank the same result;
    both 2D orientations the same bits. Returns the per-rank numbers
    (with ``dimenet``, ``sd_rank``'s arguments, each rank's
    sharded_dimenet record under ``sharded_dimenet``; with ``recsys``,
    ``sr_rank``'s, its sharded_recsys record under ``sharded_recsys``)."""
    import tempfile

    from repro_torch.launch.mesh import spawn_world

    with tempfile.TemporaryDirectory(prefix="chip_smoke_se_") as tmp:
        rows_path = Path(tmp) / "rows.npz"
        np.savez(rows_path, **rows)
        t0 = time.perf_counter()
        ranks = spawn_world(se_rank, SE_RANKS, backend="gloo",
                            root=Path(tmp) / "world",
                            args=(str(rows_path), vocab, device, dimenet,
                                  recsys),
                            timeout=SE_TIMEOUT_S)
        seconds = time.perf_counter() - t0
    failed = []
    for (case, b), first in ranks[0]["cases"].items():
        name, axis, pruned = SE_WORLD[case]
        v1, i1 = (t.numpy() for t in one[(name, "pruned" if pruned
                                           else "exact", b)])
        for r, rank in enumerate(ranks):
            got = rank["cases"][(case, b)]
            if not (np.array_equal(got["v"], first["v"])
                    and np.array_equal(got["i"], first["i"])):
                failed.append(f"{case} {b}: rank {r} differs from rank 0")
            if not (np.array_equal(got["i"], i1)
                    and np.array_equal(got["v"], v1)):
                failed.append(f"{case} {b}: rank {r} is not the one-process "
                              f"result bit for bit")
    for tag in ("", "_pruned"):
        for b in ("B8", "B64"):
            a, c = (ranks[0]["cases"][(f"grid_{o}{tag}", b)]
                    for o in ("doc_term", "term_doc"))
            if not (np.array_equal(a["v"], c["v"])
                    and np.array_equal(a["i"], c["i"])):
                failed.append(f"grid{tag} {b}: the two orientations differ")
    require(not failed, "; ".join(failed))
    dimenet_ranks = [rank.pop("sharded_dimenet", None) for rank in ranks]
    recsys_ranks = [rank.pop("sharded_recsys", None) for rank in ranks]
    return {"seconds": seconds, "sharded_dimenet": dimenet_ranks,
            "sharded_recsys": recsys_ranks,
            "per_rank": [
        {"coords": rank["coords"], "device": rank["device"],
         "cases": {f"{case}|{b}": {key: c[key] for key in (
             "host_ms", "host_ms_range", "collectives")}
             for (case, b), c in rank["cases"].items()}}
        for rank in ranks]}


def se_exact_scores(torch, builder, queries, device):
    """``(B, n_slots)`` exact scores of every slot of ``builder``'s rows
    (the query's dense weights gathered at each row's ids)."""
    from repro_torch.retrieval.engine.pruning import query_dense

    q = query_dense(queries, builder.vocab_size, device)
    vals = torch.from_numpy(builder._values).to(device)
    ids = torch.from_numpy(builder._indices).to(device).long()
    return (q[:, ids] * vals).sum(dim=2)


def se_engines(torch, served, rows, device="cuda"):
    """``CorpusEngine(shard_axis="term", n_shards=2)`` and one with a 2 x 2
    ``plan`` at splade_xlmr, beside a shard-free engine fed the same adds
    and removes: each grown by ``launch.serve.grow_engine`` (SE_ENGINE: one
    batch of 64 at a time, 5 % tombstoned), compacted, one more batch as
    the delta, each with its forward rows. The first engine encodes (K1);
    the others are handed the same reps for the same tokens. Each sharded
    engine searched with ``auto``, ``fused`` and ``pruned`` at B 8 and 64:
    ids equal to the shard-free engine's ``impact`` search but at near
    ties, no tombstoned id, ``fused`` launching K4 once (in place, on the
    delta), ``auto`` K4's ceiling entry once (the delta's pruned path),
    ``pruned`` none."""
    from repro_torch.kernels import impact_score as k45
    from repro_torch.launch.serve import SEED, grow_engine
    from repro_torch.retrieval.engine import (Shard2DIndex, ShardPlan,
                                              TermShardedIndex)
    from repro_torch.runtime.serving import (BatchedEncoder, BatchPolicy,
                                             CorpusEngine,
                                             make_config_encoder)

    cfg, k = served["cfg"], SERVE["topk"]
    encode = make_config_encoder(served["params"], cfg)
    memo, calls = {}, []

    def encode_once(tokens, mask):
        key = (tuple(tokens.shape), tokens.numpy().tobytes(),
               mask.numpy().tobytes())
        if key not in memo:
            calls.append(tuple(tokens.shape))
            memo[key] = encode(tokens, mask)
        return memo[key]

    kinds = {"shard_free": {}, "term": {"shard_axis": "term", "n_shards": 2},
             "grid": {"plan": ShardPlan(2, 2)}}
    engines, grown = {}, {}
    for name, kw in kinds.items():
        eng = CorpusEngine(BatchedEncoder(
            encode_once, policy=BatchPolicy(max_batch=SE_ENGINE["batch"])),
            cfg.vocab_size, keep_forward=True, device=device, **kw)
        rng = np.random.default_rng(SEED)
        t0 = time.perf_counter()
        grow_engine(eng, cfg.vocab_size, SE_ENGINE["corpus"],
                    batch=SE_ENGINE["batch"], rng=rng,
                    remove_frac=SE_ENGINE["remove_frac"])
        gone = set(range(SE_ENGINE["corpus"])) - set(eng.builder._slot)
        eng.flush(force_compact=True)
        eng.add_docs([rng.integers(1, cfg.vocab_size, size=16)
                      .astype(np.int32) for _ in range(SE_ENGINE["batch"])])
        eng.flush()
        engines[name] = eng
        grown[name] = {"seconds": time.perf_counter() - t0,
                       "stats": eng.stats()}
    for name, cls in (("term", TermShardedIndex), ("grid", Shard2DIndex)):
        st = grown[name]["stats"]
        require(isinstance(engines[name].builder._base, cls)
                and st["n_dead"] == 0
                and st["delta_docs"] == SE_ENGINE["batch"]
                and st == {**grown["shard_free"]["stats"],
                           **{key: st[key] for key in (
                               "term_shards", "doc_shards",
                               "grid_term_shards", "generation")}},
                f"sharded_engine {name}: segments {st} against the "
                f"shard-free engine's {grown['shard_free']['stats']}")
    ref = engines["shard_free"].builder
    qs = {f"B{rows[t + 'v'].shape[0]}": se_rep(rows, t)
          for t in ("q8", "q64")}
    out, failed, total = {}, [], {}
    want_launches = {
        "auto": {"impact_topk": 0, "impact_ceiling_topk": 1},
        "fused": {"impact_topk": 1, "impact_index_topk": 1,
                  "impact_ceiling_topk": 0},
        "pruned": {"impact_topk": 0, "impact_ceiling_topk": 0}}
    for b, q in qs.items():
        scores = se_exact_scores(torch, ref, q, device)
        _, ext_w = engines["shard_free"].search(q, k, method="impact")
        slot_w = torch.from_numpy(np.vectorize(
            lambda e: ref._slot.get(int(e), 0))(ext_w)).to(device)
        for name in ("term", "grid"):
            eng = engines[name]
            for method, want in want_launches.items():
                reset_k45(k45)
                vals, ext = eng.search(q, k, method=method)
                launched = k45_launches(k45)
                for key, n in launched.items():
                    total[key] = total.get(key, 0) + n
                ms, spread = se_ms(
                    torch, lambda: eng.search(q, k, method=method), device)
                ok = (np.isfinite(vals).all() and (ext >= 0).all()
                      and not gone & set(ext.ravel().tolist()))
                slot = torch.from_numpy(np.vectorize(
                    lambda e: ref._slot.get(int(e), 0))(ext)).to(device)
                hard, differ = ids_beyond_near_ties(torch, scores, slot,
                                                    slot_w)
                out[f"{name}_{method}_{b}"] = {
                    "resolved": eng.builder.resolved_method(method),
                    "launches": launched, "ids_differ": differ,
                    "beyond_near_ties": hard, "host_ms": ms,
                    "host_ms_range": spread}
                if not ok or hard:
                    failed.append(f"engine {name} {method} {b}: padding, "
                                  f"tombstoned or non-finite results, or "
                                  f"{hard} ids beyond near ties")
                if any(launched[key] != n for key, n in want.items()):
                    failed.append(f"engine {name} {method} {b}: launched "
                                  f"{launched}, expected {want}")
    require(not failed, "; ".join(failed))
    return {"grown": grown, "searches": out, "encode_calls": len(calls),
            "removed": len(gone), "search_launches": total}


def se_cli(torch):
    """The serve CLI's ``run`` once with each sharded method of SE_CLI on
    splade_bert's CONFIG with the serve phase's weights (seed 0): every
    request served, the method as asked, finite scores."""
    import dataclasses

    from repro_torch.configs.splade_bert import CONFIG
    from repro_torch.launch.serve import run
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime.serving import (FailedResult, ShedResult,
                                             make_config_encoder)

    cfg = dataclasses.replace(CONFIG, rep_topk=SERVE["rep_topk"])
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    encode = make_config_encoder(params, cfg)
    out = {}
    for method, kw in SE_CLI["runs"].items():
        t0 = time.perf_counter()
        res = run(encode, cfg.vocab_size, corpus=SE_CLI["corpus"],
                  requests=SE_CLI["requests"], topk=SE_CLI["topk"],
                  method=method, index_batch=SE_CLI["index_batch"],
                  device=torch.device("cuda"), **kw)
        unserved = [r for r in res["outcomes"].values()
                    if isinstance(r, (ShedResult, FailedResult))]
        require(not unserved and res["method"] == method
                and bool(torch.isfinite(res["vals"]).all())
                and tuple(res["vals"].shape) == (8, SE_CLI["topk"]),
                f"serve CLI --method {method}: {len(unserved)} unserved, "
                f"resolved {res['method']!r}")
        out[method] = {"args": kw, "served": len(res["served"]),
                       "lines": res["shard_lines"], "index_s": res["index_s"],
                       "serve_s": res["serve_s"],
                       "retrieve_ms": 1e3 * res["retrieve_s"],
                       "seconds": time.perf_counter() - t0}
    return out


def phase_sharded_engine(torch, served=None, rows=None, dimenet=False,
                         recsys=False):
    """The doc-, term- and 2D-sharded engines at splade_xlmr's V on the
    xlmr engine's 19456 live rows and the served queries (``engine_rows``;
    run alone, the xlmr serve and engine phases make them first): one
    process (``se_one_process``), one gloo world of SE_RANKS ranks sharing
    the card (``se_world``), the sharded ``CorpusEngine``s
    (``se_engines``) and the serve CLI's sharded methods at splade_bert
    (``se_cli``); no plain version on the card. With ``dimenet`` the
    world's ranks then run the sharded_dimenet phase (``sd_rank``), and
    with ``recsys`` the sharded_recsys part (``sr_rank``, its one-process
    references taken before the world spawns), whose seconds are
    returned apart (``sharded_dimenet``, ``sharded_recsys``) and not in
    this phase's."""
    from repro_torch.kernels import impact_score as k45
    from repro_torch.kernels import sparton as k1

    t0 = time.perf_counter()
    if served is None:
        from repro_torch.configs.splade_xlmr import CONFIG

        served = phase_serve(torch, CONFIG, "xlmr_serve")
        engine = phase_serve_engine(torch, served, "xlmr_serve_engine",
                                    shared_gates=False)
        rows = engine_rows(served, engine["engine"].builder)
        del engine
        torch.cuda.empty_cache()
    t_start = time.perf_counter()
    vocab = served["cfg"].vocab_size
    seconds, launches = {}, {}
    with plain_guard(k1=(k1, "sparton_forward_plain"),
                     **k45_plains(k45)) as plain_on_cuda:
        t1 = time.perf_counter()
        reset_launches()
        one = se_one_process(torch, rows, vocab)
        launches["one_process"] = read_launches()
        seconds["one_process"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        with sd_hosted(torch) if dimenet else contextlib.nullcontext(
                (None, None)) as (sd_args, sd_host), \
                sr_hosted(torch) if recsys else contextlib.nullcontext(
                    (None, None)) as (sr_args, sr_host):
            world = se_world(torch, rows, vocab, one.pop("results"),
                             dimenet=sd_args, recsys=sr_args)
        sd_ranks = world.pop("sharded_dimenet")
        sharded_dimenet = sd_check(sd_ranks, sd_host) if dimenet else None
        sr_ranks = world.pop("sharded_recsys")
        sharded_recsys = sr_check(sr_ranks, sr_host) if recsys else None
        seconds["world"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        reset_launches()
        engines = se_engines(torch, served, rows)
        # K4's and K5's launches: the gated searches' (not their timing)
        launches["engines"] = {**read_launches(),
                               **engines["search_launches"]}
        k1_paths = {"engines": k1_on_tma(k1, "sharded_engine engines")}
        require(launches["engines"]["sparton_fwd"]
                == engines["encode_calls"],
                f"sharded_engine: K1 launched "
                f"{launches['engines']['sparton_fwd']} times for "
                f"{engines['encode_calls']} encode batches")
        seconds["engines"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        reset_launches()
        cli = se_cli(torch)
        launches["cli"] = read_launches()
        k1_paths["cli"] = k1_on_tma(k1, "sharded_engine cli")
        seconds["cli"] = time.perf_counter() - t1
    require(not plain_on_cuda, f"sharded_engine: plain versions ran on "
                               f"CUDA tensors: {sorted(set(plain_on_cuda))}")
    require(all(n["impact_q_topk"] == n["topk_score"] == 0
                for n in launches.values())
            and launches["one_process"]["impact_topk"] == 0,
            f"sharded_engine: K5, K6 or a one-process K4 launched: "
            f"{launches}")
    seconds["total"] = time.perf_counter() - t_start
    seconds["with_prerequisites"] = time.perf_counter() - t0
    for part in (sharded_dimenet, sharded_recsys):
        for key in ("world", "total", "with_prerequisites"):
            seconds[key] -= part["seconds"] if part else 0
    emit("sharded_engine", note=SE_NOTE, config=served["cfg"].name,
         docs=int(rows["dv"].shape[0]), width=int(rows["dv"].shape[1]),
         prune=SE_PRUNE, mesh=list(SE_MESH[0]), ranks=SE_RANKS,
         backend="gloo", one_process=one, world=world, engines=engines,
         cli=cli, launches=launches, k1_paths=k1_paths, seconds=seconds)
    return {"launches": launches, "k1_paths": k1_paths,
            "seconds": seconds["total"], "sharded_dimenet": sharded_dimenet,
            "sharded_recsys": sharded_recsys}


# --------------------------------------------------------------------------
# 19. DimeNet's row-sharded path over a mesh (sparse/distributed)
# --------------------------------------------------------------------------

SD_STEPS = 2              # sharded train steps a case, after its gradients
SD_LR = 1e-4
# name: (shape, layout, shard axes of SE_MESH, gate). (a) "balanced":
# full_graph_sm relabelled for the 2 shards of ``model`` (``sd_balanced``):
# no take or sum drops a request, so the sharded step must equal the
# one-process step (the ``data`` axis holds a second replica). Over both
# axes no layout of this graph drops nothing: its hub's 4157 in-edges
# exceed the 4 x 918 request slots its owner has in the edge-to-node sum.
# "flat": molecule's flat triplets (whole tables gathered, sums
# psum_scattered: nothing to drop) over both axes. (b) "reference":
# full_graph_sm as the reference lays it out (graph order, padded triplet
# slots on edge 0) over both axes: the drops and the difference from the
# one-process step are printed
SD_CASES = {
    "full_graph_sm_balanced": ("full_graph_sm", "balanced", ("model",), "a"),
    "molecule_flat": ("molecule", "flat", ("data", "model"), "a"),
    "full_graph_sm_reference": ("full_graph_sm", "reference",
                                ("data", "model"), "b"),
}
SD_OGB_SKIP = ("ogb_products: this world's 4 ranks share one card's 80 GB, "
               "and one block's gathered messages alone are 253 GB in f32 "
               "(its E 61,859,328 x K 8 x d 128): sharded, it still needs "
               "cards of its own")


def sd_balanced(b, dense, n, seed=53):
    """A copy of a full graph ``b`` (its dense triplets ``dense``) laid out
    for ``n`` shards: nodes go to owners of N / n each, in decreasing
    in-degree, each to the owner with the fewest in-edges so far, in a
    random order inside its block; edges in a random order; padded triplet
    slots on random edges (a masked slot adds nothing, wherever it
    points)."""
    rng = np.random.default_rng(seed)
    N, E = len(b["node_mask"]), len(b["edge_src"])
    degree = np.bincount(b["edge_dst"], minlength=N)
    cap = N // n
    load, count = np.zeros(n), np.zeros(n, np.int64)
    owner = np.empty(N, np.int64)
    for v in np.argsort(-degree, kind="stable"):
        o = min((o for o in range(n) if count[o] < cap),
                key=lambda o: load[o])
        owner[v], load[o], count[o] = o, load[o] + degree[v], count[o] + 1
    new = np.empty(N, np.int64)            # node v becomes node new[v]
    for o in range(n):
        nodes = np.flatnonzero(owner == o)
        rng.shuffle(nodes)
        new[nodes] = o * cap + np.arange(cap)
    order = rng.permutation(E)              # edge i is the old order[i]
    out = {k: v[np.argsort(new)] for k, v in b.items()
           if k in ("positions", "node_feat", "node_mask", "target")}
    out.update(edge_src=new[b["edge_src"][order]].astype(np.int32),
               edge_dst=new[b["edge_dst"][order]].astype(np.int32),
               edge_mask=b["edge_mask"][order])
    t_in, mask = (x[order] for x in dense)
    t_in = np.argsort(order)[t_in]
    out["t_in_dense"] = np.where(mask > 0, t_in, rng.integers(
        0, E, t_in.shape)).astype(np.int32)
    out["t_mask_dense"] = mask
    return out


@contextlib.contextmanager
def sd_hosted(torch):
    """Each SD_CASES batch built on the host and saved in a temporary npz:
    yields ``(sd_rank's arguments, the host's record)``; the arguments
    carry each case's config and ``n_graphs`` (0: a node-level loss)."""
    import tempfile

    from repro_torch.configs.base import SHAPES_GNN

    t0 = time.perf_counter()
    cfgs = {name: (dimenet_config(shape), SHAPES_GNN[shape].n_graphs)
            for name, (shape, *_) in SD_CASES.items()}
    graph, _, dense, secs = full_graph_host(
        cfgs["full_graph_sm_reference"][0])
    mol, mol_secs = molecule_host()
    batches = {
        "full_graph_sm_balanced": sd_balanced(
            graph, dense, sd_shards(SD_CASES["full_graph_sm_balanced"][2])),
        "molecule_flat": mol,
        "full_graph_sm_reference": dict(graph, t_in_dense=dense[0],
                                        t_mask_dense=dense[1])}
    host = {"host_s": time.perf_counter() - t0, "graph_s": secs,
            "molecule_s": mol_secs}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sd_") as tmp:
        path = Path(tmp) / "batches.npz"
        np.savez(path, **{f"{name}|{k}": v for name, b in batches.items()
                          for k, v in b.items()})
        host["host_s"] = time.perf_counter() - t0
        yield (str(path), cfgs), host


def sd_shards(axes):
    """The ranks of SE_MESH over ``axes``."""
    return int(np.prod([dict(zip(SE_MESH[1], SE_MESH[0]))[a] for a in axes]))


def sd_sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def sd_vs_one(torch, cfg, n_graphs, params, whole, loss, grads):
    """The one-process step (``gnn_loss`` on the whole batch, this rank's
    device) at f32 and f64 against the sharded ``loss`` and ``grads``: the
    loss's relative difference, each leaf's largest difference over its
    largest |value| (worst first), and whether each is held as
    ``DIMENET_TOL``'s note holds the card to the CPU (within the
    tolerance, or no further from the f64 step than twice the one-process
    f32 step is)."""
    from repro_torch.launch.steps import gnn_loss, value_and_grad
    from repro_torch.tree import tree_map

    grad_fn = value_and_grad(gnn_loss(cfg, n_graphs))
    one_loss, one = grad_fn(params, whole)

    def f64(x):
        return x.double() if x.is_floating_point() else x

    _, g64 = grad_fn(tree_map(f64, params),
                     {k: f64(v) for k, v in whole.items()})
    host = lambda t: tree_map(lambda x: x.cpu(), t)  # noqa: E731
    one, g64 = host(one), host(g64)
    errs = leaf_errors(torch, grads, one)
    vs64, one64 = (dict(leaf_errors(torch, g, g64)) for g in (grads, one))
    held = {p: e <= DIMENET_TOL or vs64[p] <= 2 * one64[p] for p, e in errs}
    loss_rel = abs(float(loss) - float(one_loss)) / max(
        abs(float(one_loss)), 1e-30)
    return {"loss": float(loss), "one_process_loss": float(one_loss),
            "loss_rel": loss_rel,
            "worst_leaves": [{"leaf": p, "vs_one_process": e,
                              "vs_f64": vs64[p], "one_process_vs_f64":
                              one64[p]} for p, e in errs[:3]],
            "leaves_beyond_tol": sum(e > DIMENET_TOL for _, e in errs),
            "within_tol": loss_rel <= DIMENET_TOL and all(held.values())}


def sd_rank(torch, rank, mesh, path, cfgs):
    """One rank's sharded_dimenet: for each SD_CASES case, this rank's
    blocks of the batch (``gnn_batch_block``) and a seeded state (the same
    on every rank); the loss and the gradients of ``gnn_loss`` over the
    case's axes, summed over them as the step sums them, with each take's
    and sum's dropped count (``DROPS``) and gloo's time by collective
    (``TALLY``); on rank 0 these against the one-process step
    (``sd_vs_one``); then SD_STEPS steps of ``build_gnn_train_step`` over
    the mesh, the first taken twice (whether the two give the same bits),
    each step's host ms (synchronised) and whether every rank holds the
    same state bits after it. K1-K6 must launch no time."""
    from repro_torch import collectives
    from repro_torch.launch.steps import (build_gnn_train_step,
                                          gnn_batch_block, gnn_loss,
                                          new_state, value_and_grad)
    from repro_torch.sparse.distributed import DROPS
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    reset_launches()
    device = mesh.device
    with np.load(path) as z:
        host = {k: z[k] for k in z.files}
    out = {"cases": {}}
    for name, (shape, layout, axes, gate) in SD_CASES.items():
        cfg, n_graphs = cfgs[name]
        whole = {k.split("|")[1]: torch.from_numpy(v).to(device)
                 for k, v in host.items() if k.split("|")[0] == name}
        blk = gnn_batch_block(whole, mesh, axes, n_graphs=n_graphs)
        state = new_state(cfg, torch.Generator(device=device).manual_seed(47))
        rec = {"shape": shape, "layout": layout, "axes": list(axes),
               "gate": gate}
        sd_sync(torch, device)
        collectives.TALLY.reset(synchronize=True)
        DROPS.reset()
        t1 = time.perf_counter()
        loss, grads = value_and_grad(gnn_loss(
            cfg, n_graphs, shard_axes=axes, mesh=mesh))(state["params"], blk)
        with torch.no_grad():
            grads = tree_map(lambda g: collectives.psum(g, axes, mesh),
                             grads)
        sd_sync(torch, device)
        rec["grads_ms"] = 1e3 * (time.perf_counter() - t1)
        rec["drops"] = DROPS.summary()
        DROPS.reset(on=False)
        rec["collectives"] = collectives.TALLY.summary()
        collectives.TALLY.reset()
        if rank == 0:
            rec["vs_one_process"] = sd_vs_one(
                torch, cfg, n_graphs, state["params"], whole, loss, grads)
        del grads
        step = build_gnn_train_step(cfg, n_graphs=n_graphs, lr=SD_LR,
                                    shard_axes=axes, mesh=mesh)
        rec.update(step_ms=[], losses=[], same_bits_over_ranks=[])
        for i in range(SD_STEPS):
            sd_sync(torch, device)
            t1 = time.perf_counter()
            new, m = step(state, blk)
            sd_sync(torch, device)
            rec["step_ms"].append(1e3 * (time.perf_counter() - t1))
            rec["losses"].append(float(m["loss"]))
            kept = {"params": new["params"], "opt": new["opt"]}
            if i == 0:
                again, _ = step(state, blk)
                rec["two_runs_same_bits"] = same_bits_tree(
                    torch, kept, {"params": again["params"],
                                  "opt": again["opt"]})
                del again
            rec["same_bits_over_ranks"].append(
                bits_over_ranks(torch, mesh, kept))
            state = new
        out["cases"][name] = rec
        del state, new, kept, whole, blk
    out["launches"] = read_launches()
    out["seconds"] = time.perf_counter() - t0
    return out


def sd_check(ranks, host):
    """The gates of sharded_dimenet over every rank's ``sd_rank`` record:
    (a) the drop-free cases drop nothing and equal the one-process step;
    (b) the reference's layout: printed; (c) each step the same state bits
    on every rank, two runs of a step the same bits; every loss finite,
    every rank the same dropped counts, no kernel launched. Emits the
    phase's line; its seconds: the host's batches, the ranks' work (the
    slowest rank's) and this check."""
    t0 = time.perf_counter()
    failed = []
    first = ranks[0]["cases"]
    for name, rec in first.items():
        counts = [n for _, n in rec["drops"]]
        if any([n for _, n in r["cases"][name]["drops"]] != counts
               for r in ranks):
            failed.append(f"{name}: the ranks count other drops")
        if rec["gate"] == "a":
            if any(counts):
                failed.append(f"{name}: requests dropped: {counts}")
            if not rec["vs_one_process"]["within_tol"]:
                failed.append(f"{name}: sharded vs one process "
                              f"{rec['vs_one_process']}")
        for r, rank in enumerate(ranks):
            got = rank["cases"][name]
            if not (all(got["same_bits_over_ranks"])
                    and got["two_runs_same_bits"]):
                failed.append(f"{name}: rank {r}: state bits differ over "
                              f"ranks or runs")
            if not all(np.isfinite(got["losses"])):
                failed.append(f"{name}: rank {r}: losses {got['losses']}")
    if any(any(rank["launches"].values()) for rank in ranks):
        failed.append(f"a kernel launched: "
                      f"{[rank['launches'] for rank in ranks]}")
    require(not failed, "sharded_dimenet: " + "; ".join(failed))
    seconds = (host["host_s"] + max(r["seconds"] for r in ranks)
               + time.perf_counter() - t0)
    cases = {}
    for name, rec in first.items():
        cases[name] = {
            **{k: rec[k] for k in ("shape", "layout", "axes", "gate",
                                   "losses", "two_runs_same_bits")},
            "shards": sd_shards(rec["axes"]),
            "drops": rec["drops"], "dropped": sum(n for _, n in rec["drops"]),
            "vs_one_process": rec["vs_one_process"],
            "per_rank": [{"grads_ms": r["cases"][name]["grads_ms"],
                          "step_ms": r["cases"][name]["step_ms"],
                          "collectives": r["cases"][name]["collectives"]}
                         for r in ranks]}
    emit("sharded_dimenet", note=SE_NOTE, mesh=list(SE_MESH[0]),
         axes=list(SE_MESH[1]), ranks=len(ranks), backend="gloo",
         config="dimenet", steps=SD_STEPS, lr=SD_LR, cases=cases,
         skipped={"ogb_products": SD_OGB_SKIP}, host=host,
         seconds=seconds,
         rank_seconds=[r["seconds"] for r in ranks])
    return {"seconds": seconds}


def sd_alone_rank(rank, path, cfgs, device):
    import torch

    from repro_torch.launch.mesh import Mesh

    return sd_rank(torch, rank, Mesh(*SE_MESH, device=device), path, cfgs)


def phase_sharded_dimenet(torch, device="cuda"):
    """DimeNet's row-sharded path at its full CONFIG (f32, TF32 off) in a
    gloo world of SE_RANKS ranks sharing the card on SE_MESH: the cases of
    SD_CASES (``sd_rank``), gated by ``sd_check``. In the whole script it
    runs in the sharded_engine phase's world (no second spawn); alone
    (``--only sharded_dimenet``) in a world of its own."""
    import tempfile

    from repro_torch.launch.mesh import spawn_world

    with sd_hosted(torch) as ((path, cfgs), host), \
            tempfile.TemporaryDirectory(prefix="chip_smoke_sd_") as tmp:
        ranks = spawn_world(sd_alone_rank, SE_RANKS, backend="gloo",
                            root=Path(tmp) / "world",
                            args=(path, cfgs, device),
                            timeout=SE_TIMEOUT_S)
    return sd_check(ranks, host)


# --------------------------------------------------------------------------
# 20. the recsys steps over a mesh (sparse/sharded_embedding)
# --------------------------------------------------------------------------

SR_CONFIG = "dlrm"          # recsys_config's DLRM: tables capped at 2**21
SR_SEED = 43                # the state's seed, the same in every process
SR_TRAIN = 65536            # train_batch rows in all (32768 a data rank)
SR_SERVE = 512              # serve_p99
SR_RETRIEVAL = (1, 8, 64)   # query rows at retrieval_cand (B 1 published)
SR_PROBES = 256             # rows of each table compared after step 1
SR_LOSS_RTOL = 1e-5
# each leaf's largest difference from the one-process step after step 1,
# over the largest move the one-process step made in it (its update, or
# its accumulator's growth): the mesh sums the batch's gradient in
# other groupings (two data shares, psums) and F.embedding's backward
# adds repeated ids with atomics (not the same bits run to run), so the
# gradients differ in their last bits; Adagrad's update moves at most
# 3.2 lr per unit of gradient
SR_UPDATE_TOL = 1e-3
SR_PROB_TOL = 1e-5          # serve probabilities, absolute
SR_PUBLISHED = ((2, 2), (2, 4))   # meshes of the published DLRM's count
SR_TIMEOUT_S = 300


def sr_candidates(torch, cfg, device):
    """retrieval_cand's seeded ``(N, embed_dim)`` f32 candidates."""
    g = torch.Generator(device=device).manual_seed(37)
    return torch.randn((RECSYS_RETRIEVAL["N"], cfg.embed_dim), generator=g,
                       device=device)


def sr_counts(cfg):
    """The state specs of SE_MESH (``state_shardings(recsys_param_specs(
    ...), ..., "adagrad")``, which read only the mesh's shape: the ranks
    are given them, and build no meta tensors, whose first use imports
    ``torch._dynamo`` for ~10 s a process) and the state's bytes a rank
    by the specs (``state_nbytes`` on ``AbstractMesh``es over meta
    tensors): DLRM as the card runs it at SE_MESH and whole, and the
    published DLRM at SR_PUBLISHED."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as S
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.steps import init_params

    def count(c, shape):
        meta = init_params(c, torch.Generator(), device="meta")
        state = {"params": meta, "opt": {"acc": meta}, "step": 0}
        mesh = AbstractMesh(shape, SE_MESH[1])
        specs = S.state_shardings(S.recsys_param_specs(c, mesh), meta,
                                  "adagrad", mesh)
        return S.state_nbytes(mesh, specs, state), specs

    published = get_config(RECSYS[SR_CONFIG]).CONFIG
    rank, specs = count(cfg, SE_MESH[0])
    return {"rank": rank, "whole": count(cfg, (1, 1))[0],
            "published_whole": count(published, (1, 1))[0],
            "published_rank": {"x".join(map(str, m)): count(published, m)[0]
                               for m in SR_PUBLISHED}}, specs


def sr_probes(cfg, batch):
    """Each table's probe rows: up to SR_PROBES of the batch's distinct ids
    in its field, evenly spaced in id order (so every block of a large
    table is read), and its first and last rows."""
    ids = batch["sparse_idx"].cpu().numpy()
    out = {}
    for f, rows in enumerate(cfg.table_sizes):
        seen = np.unique(ids[:, f])
        pick = seen[np.linspace(0, len(seen) - 1,
                                min(SR_PROBES, len(seen))).astype(int)]
        out[f] = np.unique(np.concatenate([pick, [0, rows - 1]]))
    return out


@contextlib.contextmanager
def sr_hosted(torch, device="cuda"):
    """The one-process references, taken on the card before the world
    spawns (the step needs ~35 GB, which the ranks' blocks would crowd):
    DLRM's state from SR_SEED, the serve step at SR_SERVE, the retrieval
    step and K6 (the check) at each SR_RETRIEVAL batch, then one step
    of ``build_recsys_train_step`` at SR_TRAIN. Saved to a temporary npz
    (the loss, each table's probe rows and every MLP leaf before and
    after, the probabilities, the ids and values); yields ``(sr_rank's
    arguments, the host's record)``."""
    import tempfile

    from repro_torch.kernels.topk_score import topk_score
    from repro_torch.launch.steps import (build_recsys_serve_step,
                                          build_recsys_train_step,
                                          build_retrieval_step, new_state)
    from repro_torch.models.recsys import user_embedding
    from repro_torch.tree import tree_items

    t0 = time.perf_counter()
    dev, k = torch.device(device), RECSYS_RETRIEVAL["k"]
    cfg, cut = recsys_config(SR_CONFIG)
    counts, specs = sr_counts(cfg)
    host = {"rows_cut": cut, "counts": counts,
            "counts_s": time.perf_counter() - t0}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = new_state(cfg, torch.Generator(device=dev).manual_seed(SR_SEED))
    params = state["params"]
    out = {"serve": build_recsys_serve_step(cfg)(params, recsys_batch(
        torch, cfg, SR_SERVE, 6, dev)).cpu().numpy()}
    reset_launches()
    for B in SR_RETRIEVAL:
        batch = recsys_batch(torch, cfg, B, 7, dev)
        batch["candidates"] = sr_candidates(torch, cfg, dev)
        v, i = build_retrieval_step(cfg, k=k)(params, batch)
        with torch.no_grad():
            vk, ik = topk_score(user_embedding(params, cfg, batch),
                                batch["candidates"], k=k)
        out.update({f"B{B}|v": v.cpu().numpy(), f"B{B}|i": i.cpu().numpy(),
                    f"B{B}|k6_v": vk.cpu().numpy(),
                    f"B{B}|k6_i": ik.cpu().numpy()})
        del batch
    host["check_launches"] = read_launches()
    require(dev.type != "cuda" or host["check_launches"]["topk_score"]
            == len(SR_RETRIEVAL), f"sharded_recsys: K6 launched "
            f"{host['check_launches']} for {len(SR_RETRIEVAL)} checks")
    host["references_s"] = time.perf_counter() - t0
    batch = recsys_batch(torch, cfg, SR_TRAIN, 5, dev)
    step = build_recsys_train_step(cfg)
    step(state, batch)                      # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    new, m = step(state, batch)
    torch.cuda.synchronize()
    host.update(one_process_ms=1e3 * (time.perf_counter() - t1),
                one_process_peak_gib=torch.cuda.max_memory_allocated()
                / 2**30, loss=float(m["loss"]))
    out["loss"] = np.float64(host["loss"])
    probes = sr_probes(cfg, batch)
    for part, tree in (("old", params), ("new", new["params"]),
                       ("acc", new["opt"]["acc"])):
        for name, leaf in tree_items(tree).items():
            if name.startswith("tables/"):
                f = int(name.split("/")[1])
                out[f"probe|{f}"] = probes[f]
                leaf = leaf[torch.from_numpy(probes[f]).to(dev)]
            out[f"{part}|{name}"] = leaf.cpu().numpy()
    del state, params, new, batch, m
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sr_") as tmp:
        path = Path(tmp) / "one_process.npz"
        np.savez(path, **out)
        host.update(host_s=time.perf_counter() - t0, one=out)
        yield (str(path), specs), host


def sr_block_rows(torch, mesh, spec, rows):
    """``[lo, hi)``: the global rows of this rank's block under ``spec``'s
    dimension 0."""
    from repro_torch.launch.mesh import axis_index, axis_size

    axes = spec[0]
    if not axes:
        return 0, rows
    n = rows // axis_size(mesh, axes)
    lo = axis_index(mesh, axes) * n
    return lo, lo + n


def sr_rank(torch, rank, mesh, path, specs):
    """One rank's sharded_recsys on SE_MESH: DLRM's state built by
    ``new_state(mesh=, specs=)`` from SR_SEED (``specs``: ``sr_counts``'
    state specs) and its bytes; the serve step and the retrieval
    step (its candidates cut by ``candidate_block``) held against the
    one-process results (rank 0: ``stream_compare`` against the step's
    and K6's ids); one step of ``build_recsys_train_step(mesh=,
    param_specs=, zero_specs=)`` with gloo's time by collective
    (``TALLY``, synchronised), this rank's probe rows and (rank 0) the
    MLPs and their gathered accumulators after it, every block the same
    bits on the ranks holding it; then a second step timed. K1-K6 must
    launch no time."""
    from repro_torch import collectives
    from repro_torch.launch import sharding as S
    from repro_torch.launch.steps import (build_recsys_serve_step,
                                          build_recsys_train_step,
                                          build_retrieval_step, new_state)
    from repro_torch.models.recsys import padded_rows, user_embedding
    from repro_torch.tree import tree_items, tree_leaves

    t0 = time.perf_counter()
    dev, k = mesh.device, RECSYS_RETRIEVAL["k"]
    torch.cuda.empty_cache()
    marks = {"cuda": time.perf_counter()}
    reset_launches()
    one = dict(np.load(path))
    cfg, _ = recsys_config(SR_CONFIG)
    ps = specs["params"]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.perf_counter()
    state = new_state(cfg, torch.Generator(device=dev).manual_seed(SR_SEED),
                      mesh=mesh, specs=specs)
    torch.cuda.synchronize(dev)
    rec = {"coords": dict(mesh.coords), "build_s": time.perf_counter() - t1,
           "nbytes": sum(t.nbytes for t in tree_leaves(state)
                         if isinstance(t, torch.Tensor)),
           "build_peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    params = state["params"]
    marks["build"] = time.perf_counter()

    serve = build_recsys_serve_step(cfg, mesh, ps)
    sb = recsys_batch(torch, cfg, SR_SERVE, 6, dev)
    p = serve(params, sb)
    rec["serve"] = {"max_abs_err": float(np.abs(
        p.cpu().numpy() - one["serve"]).max()),
        "finite": bool(torch.isfinite(p).all())}
    rec["serve"]["host_ms"], rec["serve"]["host_ms_range"] = host_ms(
        torch, lambda: serve(params, sb), n=5)
    marks["serve"] = time.perf_counter()
    retrieve = build_retrieval_step(cfg, mesh, k=k, param_specs=ps)
    rec["retrieval"] = {}
    for B in SR_RETRIEVAL:
        qb = recsys_batch(torch, cfg, B, 7, dev)
        C = sr_candidates(torch, cfg, dev)
        qb["candidates"] = S.candidate_block(mesh, C).clone()
        if rank:
            del C
        v, i = retrieve(params, qb)
        row = {"rows_local": int(qb["candidates"].shape[0])}
        if rank == 0:
            with torch.no_grad():
                qv = user_embedding(params, cfg, qb)
            want = {src: tuple(torch.from_numpy(one[f"B{B}|{key}"]).to(dev)
                               for key in keys)
                    for src, keys in (("one_process", ("v", "i")),
                                      ("k6", ("k6_v", "k6_i")))}
            row.update({f"vs_{src}": stream_compare(torch, qv, C, (v, i), w)
                        for src, w in want.items()})
            del C
        row["host_ms"], row["host_ms_range"] = host_ms(
            torch, lambda: retrieve(params, qb), n=5)
        rec["retrieval"][f"B{B}"] = row
        del qb
    marks["retrieval"] = time.perf_counter()

    step = build_recsys_train_step(cfg, mesh=mesh, param_specs=ps,
                                   zero_specs=specs["opt"]["acc"])
    batch = recsys_batch(torch, cfg, SR_TRAIN, 5, dev)
    body = {"params": specs["params"], "opt": specs["opt"]}
    torch.cuda.synchronize(dev)
    collectives.TALLY.reset(synchronize=True)
    t1 = time.perf_counter()
    new, m = step(state, batch)
    torch.cuda.synchronize(dev)
    rec["step1_ms"] = 1e3 * (time.perf_counter() - t1)
    rec["collectives"] = collectives.TALLY.summary()
    collectives.TALLY.reset()
    rec["losses"] = [float(m["loss"])]
    marks["step1"] = time.perf_counter()
    rec["probes"] = {}
    for part, tree, sp in (("new", new["params"], ps),
                           ("acc", new["opt"]["acc"], specs["opt"]["acc"])):
        for f, leaf in enumerate(tree["tables"]):
            lo, hi = sr_block_rows(torch, mesh, sp["tables"][f],
                                   padded_rows(cfg.table_sizes[f]))
            ids = one[f"probe|{f}"]
            mine = ids[(ids >= lo) & (ids < hi)]
            rec["probes"][f"{part}|tables/{f}"] = (mine, leaf[
                torch.from_numpy(mine - lo).to(dev)].cpu().numpy())
    mlp = ("bot_mlp", "top_mlp")
    acc = S.gather_state(mesh, {n: specs["opt"]["acc"][n] for n in mlp},
                         {n: new["opt"]["acc"][n] for n in mlp})
    if rank == 0:
        rec["mlp"] = {**{f"new|{n}": v.cpu().numpy() for n, v in tree_items(
            {n: new["params"][n] for n in mlp}).items()},
            **{f"acc|{n}": v.cpu().numpy() for n, v in tree_items(
                acc).items()}}
    del acc
    rec["same_bits"] = [holders_agree(torch, mesh, body, {
        "params": new["params"], "opt": new["opt"]})]
    del state, params
    marks["step1_checks"] = time.perf_counter()
    torch.cuda.synchronize(dev)
    collectives.TALLY.reset()
    t1 = time.perf_counter()
    new2, m = step(new, batch)
    torch.cuda.synchronize(dev)
    rec["step2_ms"] = 1e3 * (time.perf_counter() - t1)
    rec["step2_collectives"] = collectives.TALLY.summary()
    rec["losses"].append(float(m["loss"]))
    rec["same_bits"].append(holders_agree(torch, mesh, body, {
        "params": new2["params"], "opt": new2["opt"]}))
    rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    rec["launches"] = read_launches()
    del new, new2, batch
    torch.cuda.empty_cache()
    marks["step2"] = time.perf_counter()
    rec["seconds"] = marks["step2"] - t0
    rec["split_s"] = {key: t - last for (key, t), last in zip(
        marks.items(), [t0] + list(marks.values())[:-1])}
    return rec


def sr_moved(got, want, old):
    """A leaf's largest difference from the one-process value over the
    largest move the one-process step made in it."""
    scale = float(np.abs(want - old).max())
    return float(np.abs(got - want).max()) / max(scale, 1e-30)


def sr_check(ranks, host):
    """The gates of sharded_recsys over every rank's ``sr_rank`` record:
    each rank's state bytes the specs' count; step 1's loss within
    SR_LOSS_RTOL of the one-process step's and every probe row and MLP
    leaf after it within SR_UPDATE_TOL (``sr_moved``); the serve
    probabilities within SR_PROB_TOL; the retrieval ids equal to the
    one-process step's and K6's but at near ties; every block the same
    bits on its holders after each step; the losses finite; no kernel
    launched on a rank. Emits the part's line; its seconds: the host's
    references, the ranks' work (the slowest rank's) and this check."""
    t0 = time.perf_counter()
    one, counts, failed = host.pop("one"), host["counts"], []
    loss = float(one["loss"])
    for r, rank in enumerate(ranks):
        if rank["nbytes"] != counts["rank"]:
            failed.append(f"rank {r}: holds {rank['nbytes']} bytes, the "
                          f"specs {counts['rank']}")
        rel = abs(rank["losses"][0] - loss) / abs(loss)
        if rel > SR_LOSS_RTOL or not np.isfinite(rank["losses"]).all():
            failed.append(f"rank {r}: losses {rank['losses']} against the "
                          f"one-process {loss}")
        if not all(rank["same_bits"]):
            failed.append(f"rank {r}: a block differs from its holders'")
        if any(rank["launches"].values()):
            failed.append(f"rank {r}: a kernel launched {rank['launches']}")
        if not (rank["serve"]["finite"]
                and rank["serve"]["max_abs_err"] <= SR_PROB_TOL):
            failed.append(f"rank {r}: serve {rank['serve']}")
    for b, row in ranks[0]["retrieval"].items():
        for src in ("one_process", "k6"):
            if not row[f"vs_{src}"]["within_tol"]:
                failed.append(f"retrieval {b} vs {src}: {row[f'vs_{src}']}")
    moved = {}
    for key, want in one.items():
        part, _, name = key.partition("|")
        if part not in ("new", "acc"):
            continue
        old = one[f"old|{name}"] if part == "new" else np.float32(0.1)
        if name.startswith("tables/"):
            rows = {}
            for rank in ranks:
                ids, got = rank["probes"][key]
                rows.update(zip(ids.tolist(), got))
            ids = one[f"probe|{name.split('/')[1]}"]
            if set(rows) != set(ids.tolist()):
                failed.append(f"{key}: probe rows missing")
                continue
            got = np.stack([rows[i] for i in ids.tolist()])
        else:
            got = ranks[0]["mlp"][key]
        moved[key] = sr_moved(got, want, old)
    worst = sorted(moved.items(), key=lambda kv: -kv[1])
    if not worst or worst[0][1] > SR_UPDATE_TOL:
        failed.append(f"updates beyond {SR_UPDATE_TOL}: {worst[:3]}")
    require(not failed, "sharded_recsys: " + "; ".join(failed))
    seconds = (host["host_s"] + max(r["seconds"] for r in ranks)
               + time.perf_counter() - t0)
    launches = {"ranks": {key: sum(r["launches"][key] for r in ranks)
                          for key in ranks[0]["launches"]},
                "check": host["check_launches"]}
    first = ranks[0]
    emit("sharded_recsys", note=SE_NOTE, config=RECSYS[SR_CONFIG],
         mesh=list(SE_MESH[0]), axes=list(SE_MESH[1]), ranks=len(ranks),
         backend="gloo", train_batch=SR_TRAIN, serve_batch=SR_SERVE,
         rows_cut=host["rows_cut"], state_bytes=counts,
         one_process={k: host[k] for k in ("loss", "one_process_ms",
                                           "one_process_peak_gib")},
         loss_rel=abs(first["losses"][0] - loss) / abs(loss),
         losses=first["losses"], worst_moved=worst[:5],
         leaves_compared=len(moved), update_tol=SR_UPDATE_TOL,
         retrieval=first["retrieval"],
         per_rank=[{key: r[key] for key in (
             "coords", "nbytes", "build_s", "build_peak_gib", "step1_ms",
             "step2_ms", "peak_gib", "collectives", "step2_collectives",
             "serve", "seconds", "split_s")} for r in ranks],
         launches=launches, seconds=seconds,
         host_s={key: host[key] for key in ("counts_s", "references_s",
                                            "host_s")})
    return {"seconds": seconds, "launches": launches}


def sr_alone_rank(rank, path, specs, device):
    import torch

    from repro_torch.launch.mesh import Mesh

    return sr_rank(torch, rank, Mesh(*SE_MESH, device=device), path, specs)


def phase_sharded_recsys(torch, device="cuda"):
    """The recsys steps over SE_MESH at DLRM's published width (tables
    capped at DLRM_ROW_CAP) in a gloo world of SE_RANKS ranks sharing
    the card (``sr_rank``), held to the one-process references of
    ``sr_hosted`` by ``sr_check``. In the whole script it runs in the
    sharded_engine phase's world after sharded_dimenet; alone (``--only
    sharded_recsys``) in a world of its own."""
    import tempfile

    from repro_torch.launch.mesh import spawn_world

    with sr_hosted(torch, device) as ((path, specs), host), \
            tempfile.TemporaryDirectory(prefix="chip_smoke_sr_") as tmp:
        ranks = spawn_world(sr_alone_rank, SE_RANKS, backend="gloo",
                            root=Path(tmp) / "world",
                            args=(path, specs, device), timeout=SR_TIMEOUT_S)
    return sr_check(ranks, host)


ALONE = {"recsys": phase_recsys, "dimenet": phase_dimenet,
         "dryrun": phase_dryrun, "sharded": phase_sharded,
         "sharded_engine": phase_sharded_engine,
         "sharded_dimenet": phase_sharded_dimenet,
         "sharded_recsys": phase_sharded_recsys}


def only_phases(torch, names) -> int:
    """``python3 chip_smoke.py --only recsys dimenet``: the device and
    build phases, then each phase named (of ``ALONE``) with its gates, in
    the order given; no kernels line and no last line."""
    if not names or any(name not in ALONE for name in names):
        print(f"chip_smoke --only: the phases that run alone are "
              f"{sorted(ALONE)}", file=sys.stderr)
        return 2
    phase_device(torch)
    phase_build()
    for name in names:
        ALONE[name](torch)
    return 0


def kernel_rows(measured, launches, dense_launches, engine_launches,
                train_launches, k1_paths, xlmr, eval_launches, ckpt_launches,
                pruned, frontier, examples, decoder, moe, train_decoder,
                recsys, dryrun, sharded, sharded_engine):
    """The ``{"kernels": [...]}`` line: each kernel's launches on its path
    and its numbers from the timing phase (K1 at an index batch, K2/K3 at
    the train shape, K4, K5 and K6 at the served queries; K1 also at the
    train shape and K4, K5 and K6 also at all 64 served requests; K4's and
    K5's ``ms`` are their index entries', ``window_ms`` their window
    entries'); K1, K2 and K3 also ``at_xlmr``, at train_420 with xlmr's
    V (K2 and K3 on the "dense" and "sparse" routings), with their
    launches in the xlmr phase's serve, serving and train_420 runs; K4
    ``at_xlmr`` its launches in the xlmr serve and engine phases and its
    ceiling entry's in xlmr_serve_pruned with that phase's numbers, K5
    ``at_xlmr`` its launches in xlmr_serve_engine and its numbers on that
    engine's base (8 and 64 queries), K6 ``at_xlmr`` its launches in
    xlmr_serve_dense and its numbers at B 8 on that (16384, 250002)
    corpus; K1-K5 also
    ``eval_launches``, in each part of the eval phase, and every kernel
    ``ckpt_launches``, in the ckpt phase's first and resumed CLI runs and
    its example run. K4's row also holds its ceiling entry (``ceiling``):
    its launches in the serve_pruned phase and the eval phase, its
    numbers at the served 8 queries and the search's budget C + 1
    (``k4_ms``: K4 in place on the same queries at the same k), also at
    all 64 served requests and at k 257. K1's and K4's rows hold their
    launches in the serve_frontier phase (``frontier_launches``; K4's by
    entry), and K4's its window entry's numbers at the hot windows' shape
    there (``hot_window``: ``in_place_ms`` K4 in place on the same
    queries). Every row also holds its launches in the example_serve
    phase (a count for each flag set; K4's ceiling entry apart),
    the example_quickstart phase and the streaming phase
    (``examples``), and K6's row its numbers at the retrieval_cand shape
    for B 1, 8 and 64 (``at_retrieval_cand``, ``stream_ms`` that of
    ``launch.steps.streaming_topk``). Every row holds its launches in
    the decoder phase's runs (``decoder_launches``: the llama serve, each
    prefill and each decode comparison), and K1's row its numbers at the
    decoder shapes (``at_decoder``: the serve batch, llama's prefill at B
    1 and 2 x 32768, gemma2's at 2 x 8192 with softcap 30, each with the
    paper's baseline head's ``naive_ms``), and K4's its numbers on the
    llama serve's V 128256 index at the served 8 queries and all 64.
    Likewise for the moe phase: every row's ``moe_launches`` (the
    moonshot serve, each prefill and each decode comparison), K1's
    ``at_moe`` (moonshot's serve batch and 2 x 8192, phi3.5-moe's 2 x
    8192) and K4's ``at_moe`` (moonshot's V 163840 index). And for the
    train_decoder phase: every row's ``train_decoder_launches`` (the last
    timed step of llama, gemma2 and moonshot: 2 x n_micro for K1-K3, 0
    for K4-K6), K2's and K3's ``at_train_decoder`` (the five decoders'
    (D, V, softcap) at B 2 x S 4096, beside the baseline head's
    backward). Every row's ``dryrun_launches`` counts its launches in
    each measured step of the dryrun phase (2 x n_micro for K1-K3 in an
    LSR train step, K1 1 in the prefill, 0 elsewhere), and
    ``sharded_launches`` in the sharded phase's runs on each rank (its
    prefill, the last step on each mesh), ``sharded_engine_launches`` in
    the sharded_engine phase's one-process searches, engines and CLI runs
    (K1 the engines' and the CLI's encode batches, K4 the engines' delta
    searches), ``sharded_recsys_launches`` on the ranks of the
    sharded_recsys part (``ranks``, summed: none) and in its one-process
    check (``check``: K6 once a retrieval batch); K1's, K2's and K3's
    ``at_sharded`` their numbers at train_16 on rank 1's vocab rows
    (``shard``) and on the whole vocabulary (``whole``)."""
    main_k1, bwd, k4, k5, k6 = (measured[key]
                                for key in ("k1", "bwd", "k4", "k5", "k6"))
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    k1_keys = keys + ("ms_wmma",)
    serving = xlmr["serving"]
    x_launch = {"serve": xlmr["serve_launches"],
                **{f"serve_{path}": serving[path]["launches"]
                   for path in ("engine", "pruned", "dense")},
                "train_420": xlmr["train_launches"]}
    x_k1 = {**{key: xlmr["timing"]["k1"][key] for key in k1_keys},
            "launches": {where: n["sparton_fwd"]
                         for where, n in x_launch.items()}}

    def x_bwd(kernel, key):
        return {"launches": x_launch["train_420"][key],
                **{routing: {k: row[kernel][k] for k in keys}
                   for routing, row in xlmr["timing"]["bwd"].items()}}

    k6_keys = keys + ("ms_over_library",)
    k45_keys = keys + ("window_ms", "digest")

    def in_eval(key):
        return {part: n[key] for part, n in eval_launches.items()}

    def in_ckpt(key):
        return {run: n[key] for run, n in ckpt_launches.items()}

    rows = [
        {"name": "sparton_fwd (K1)", "route": "cuda",
         "source": "src/repro_torch/csrc/sparton_fwd.cu",
         "replaces": "src/repro/kernels/sparton.py:52",
         "launches": launches["sparton_fwd"],
         "dense_serve_launches": dense_launches["sparton_fwd"],
         "engine_launches": engine_launches["sparton_fwd"],
         "train_launches": train_launches["sparton_fwd"],
         "path_launches": k1_paths,
         "eval_launches": in_eval("sparton_fwd"),
         "ckpt_launches": in_ckpt("sparton_fwd"),
         "frontier_launches": frontier["launches"]["sparton_fwd"],
         **{key: main_k1[key] for key in k1_keys},
         **{f"at_{name}": {key: measured["k1_rows"][name][key]
                           for key in k1_keys}
            for name in ("query_batch", "train", "table1")},
         "at_xlmr": x_k1},
        *({"name": name, "route": "cuda",
           "source": "src/repro_torch/csrc/sparton_bwd.cu",
           "replaces": replaces, "launches": train_launches[key],
           "eval_launches": in_eval(key),
           "ckpt_launches": in_ckpt(key),
           **{k: bwd["train"][kernel][k] for k in keys},
           "at_xlmr": x_bwd(kernel, key)}
          for name, kernel, key, replaces in (
              ("sparton_bwd_dh (K2)", "dh", "sparton_bwd_dh",
               "src/repro/kernels/sparton_bwd.py:57"),
              ("sparton_bwd_de (K3)", "de", "sparton_bwd_de",
               "src/repro/kernels/sparton_bwd.py:93"))),
        {"name": "impact_topk (K4)", "route": "cuda",
         "source": "src/repro_torch/csrc/impact_topk.cu",
         "replaces": "src/repro/kernels/impact_score.py:96",
         "launches": launches["impact_topk"],
         "index_launches": launches["impact_index_topk"],
         "engine_launches": engine_launches["impact_topk"],
         "eval_launches": in_eval("impact_topk"),
         "ckpt_launches": in_ckpt("impact_topk"),
         **{key: k4["B8"][key] for key in k45_keys},
         "at_B64": {key: k4["B64"][key] for key in k45_keys},
         "ceiling": {**ceiling_row(pruned),
                     "eval_launches": in_eval("impact_ceiling_topk")},
         "frontier_launches": {
             key: frontier["launches"][key] for key in (
                 "impact_window_topk", "impact_index_topk")},
         "hot_window": {key: frontier["window"][key] for key in (
             keys + ("shape", "in_place_ms", "in_place_bound_ms",
                     "digest"))},
         "at_xlmr": {"launches": {
             where: x_launch[where]["impact_topk"]
             for where in ("serve", "serve_engine")},
             "ceiling": ceiling_row(serving["pruned"])}},
        {"name": "impact_q_topk (K5)", "route": "cuda",
         "source": "src/repro_torch/csrc/impact_topk.cu",
         "replaces": "src/repro/kernels/impact_score.py:120",
         "launches": engine_launches["impact_q_topk"],
         "eval_launches": in_eval("impact_q_topk"),
         "ckpt_launches": in_ckpt("impact_q_topk"),
         **{key: k5["B8"][key] for key in k45_keys},
         "at_B64": {key: k5["B64"][key] for key in k45_keys},
         "at_xlmr": {
             "launches": x_launch["serve_engine"]["impact_q_topk"],
             **{key: serving["k5"]["B8"][key] for key in k45_keys},
             "at_B64": {key: serving["k5"]["B64"][key]
                        for key in k45_keys}}},
        {"name": "topk_score (K6)", "route": "cuda",
         "source": "src/repro_torch/csrc/topk_score.cu",
         "replaces": "src/repro/kernels/topk_score.py:57",
         "launches": dense_launches["topk_score"],
         "ckpt_launches": in_ckpt("topk_score"),
         **{key: k6["B8"][key] for key in k6_keys},
         "at_B64": {key: k6["B64"][key] for key in k6_keys},
         "at_xlmr": {"launches": x_launch["serve_dense"]["topk_score"],
                     **{key: serving["k6"]["B8"][key]
                        for key in k6_keys}}},
    ]
    counters = ("sparton_fwd", "sparton_bwd_dh", "sparton_bwd_de",
                "impact_topk", "impact_q_topk", "topk_score")
    for row, key in zip(rows, counters, strict=True):
        row["example_serve_launches"] = {
            name: n[key] for name, n in examples["serve"].items()}
        row["example_quickstart_launches"] = examples["quickstart"][key]
        row["streaming_launches"] = examples["streaming"]["launches"][key]
        for phase, out in (("decoder", decoder), ("moe", moe),
                           ("train_decoder", train_decoder),
                           ("recsys", recsys), ("dryrun", dryrun),
                           ("sharded", sharded),
                           ("sharded_engine", sharded_engine),
                           ("sharded_recsys",
                            sharded_engine["sharded_recsys"])):
            row[f"{phase}_launches"] = {
                where: n[key] for where, n in out["launches"].items()}
    for row, kernel in ((rows[0], "k1"), (rows[1], "dh"), (rows[2], "de")):
        row["at_sharded"] = {
            where: {key: r[kernel][key] for key in keys + ("shape",)}
            for where, r in sharded["timing"].items()}
    for row, kernel in ((rows[1], "dh"), (rows[2], "de")):
        row["at_train_decoder"] = {
            name: {key: r[kernel][key] for key in keys + (
                "shape", "bound_share", "g_nonzero_share")}
            for name, r in train_decoder["timing"].items()}
    for phase, out in (("decoder", decoder), ("moe", moe)):
        rows[0][f"at_{phase}"] = {
            name: {key: r[key] for key in keys + (
                "shape", "softcap", "peak_mb", "plain_peak_mb",
                "library_peak_mb", "naive_ms", "naive_peak_mb",
                "naive_needs_bytes", "imax_mismatch")}
            for name, r in out["timing"].items()}
        rows[3][f"at_{phase}"] = {name: {key: r[key] for key in k45_keys}
                                  for name, r in out["k4"].items()}
    rows[3]["ceiling"]["example_serve_launches"] = {
        name: n["impact_ceiling_topk"]
        for name, n in examples["serve"].items()}
    rows[5]["at_recsys"] = {
        name: {key: r[key] for key in k6_keys + (
            "shape", "peak_mb", "library_peak_mb", "read_ms")}
        for name, r in recsys["k6"].items()}
    rows[5]["at_retrieval_cand"] = {
        name: {key: r[key] for key in k6_keys + (
            "shape", "k6_path", "peak_mb", "library_peak_mb", "stream_ms",
            "stream_peak_mb")}
        for name, r in examples["streaming"]["rows"].items()}
    return rows


def ceiling_row(pruned):
    """K4's ceiling entry in the kernels line (``kernel_rows``): its
    launches in a pruned phase and that phase's numbers."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "k4_ms", "k4_ms_topk", "digest")
    (first, row), *rest = pruned["timing"].items()
    return {"entry": "fused_ceiling_index_topk",
            "entry_point": "impact_ceiling_index_topk",
            "replaces": "src/repro/retrieval/engine/pruning.py:72 "
                        "(upper_bound_scores + lax.top_k)",
            "launches": pruned["launches"]["impact_ceiling_topk"],
            "at": first,
            **{key: row[key] for key in keys},
            **{f"at_{name}": {key: r[key] for key in keys}
               for name, r in rest}}


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------

def main(argv=()) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if argv and argv[0] == "--only":
        return only_phases(torch, argv[1:])
    if argv:
        return train_depth(torch, argv)
    timeline = {}

    def clocked(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        timeline[name] = time.perf_counter() - t0
        return out

    clocked("device", phase_device, torch)
    clocked("build", phase_build)
    minibatch = start_minibatch_host()
    clocked("kernels", phase_kernels, torch)
    served = clocked("serve", phase_serve, torch)
    served_dense = clocked("serve_dense", phase_serve_dense, torch, served)
    served_engine = clocked("serve_engine", phase_serve_engine, torch,
                            served)
    served_pruned = clocked("serve_pruned", phase_serve_pruned, torch,
                            served)
    frontier = clocked("serve_frontier", phase_serve_frontier, torch, served,
                       served_pruned)
    del served_pruned["engine"]
    measured = clocked("timing", phase_timing, torch, served, served_dense,
                       served_engine)
    dense_launches = served_dense["launches"]
    engine_launches = served_engine["launches"]
    k1_paths = {"serve": served["k1_paths"],
                "dense_serve": served_dense["k1_paths"],
                "engine": served_engine["k1_paths"],
                "pruned": served_pruned["k1_paths"],
                "frontier": frontier["k1_paths"]}
    # the 1.9 GiB dense corpus and the engine are not the train phase's
    # memory
    del served_dense, served_engine
    torch.cuda.empty_cache()
    trained = clocked("train", phase_train, torch)
    k1_paths["train"] = trained["k1_paths"]
    params = served.pop("params")
    del params
    torch.cuda.empty_cache()
    evaluated = clocked("eval", phase_eval, torch)
    dry_pending = start_dryrun()
    k1_paths["eval"] = evaluated["k1_paths"]
    xlmr = clocked("xlmr", phase_xlmr, torch)
    # the sharded_engine phase runs inside xlmr, on its weights and rows,
    # and the sharded_dimenet phase inside sharded_engine's gloo world
    timeline["sharded_engine"] = xlmr["sharded_engine"]["seconds"]
    timeline["sharded_dimenet"] = \
        xlmr["sharded_engine"]["sharded_dimenet"]["seconds"]
    timeline["sharded_recsys"] = \
        xlmr["sharded_engine"]["sharded_recsys"]["seconds"]
    timeline["xlmr"] -= (timeline["sharded_engine"]
                         + timeline["sharded_dimenet"]
                         + timeline["sharded_recsys"])
    k1_paths.update({f"xlmr_{where}": paths
                     for where, paths in xlmr["k1_paths"].items()})
    k1_paths.update({f"sharded_engine_{where}": paths for where, paths
                     in xlmr["sharded_engine"]["k1_paths"].items()})
    ckpt = clocked("ckpt", phase_ckpt, torch)
    k1_paths.update(ckpt["k1_paths"])
    example_serve = clocked("example_serve", phase_example_serve, torch)
    k1_paths.update({f"example_serve_{name}": paths for name, paths
                     in example_serve["k1_paths"].items()})
    quick = clocked("example_quickstart", phase_example_quickstart, torch)
    k1_paths["example_quickstart"] = quick["k1_paths"]
    examples = {"serve": example_serve["launches"],
                "quickstart": quick["launches"],
                "streaming": clocked("streaming", phase_streaming, torch)}
    decoder = clocked("decoder", phase_decoder, torch)
    k1_paths.update({f"decoder_{where}": paths
                     for where, paths in decoder["k1_paths"].items()})
    moe = clocked("moe", phase_moe, torch)
    k1_paths.update({f"moe_{where}": paths
                     for where, paths in moe["k1_paths"].items()})
    train_decoder = clocked("train_decoder", phase_train_decoder, torch)
    k1_paths.update({f"train_decoder_{where}": paths for where, paths
                     in train_decoder["k1_paths"].items()})
    recsys = clocked("recsys", phase_recsys, torch)
    clocked("dimenet", phase_dimenet, torch, minibatch)
    dry = clocked("dryrun", phase_dryrun, torch, dry_pending)
    k1_paths.update({f"dryrun_{where}": paths
                     for where, paths in dry["k1_paths"].items()})
    sharded = clocked("sharded", phase_sharded, torch,
                      xlmr["grad_check"]["bfloat16"]["limit"])
    emit("timeline", seconds=timeline, total=sum(timeline.values()))
    print(json.dumps({"kernels": kernel_rows(
        measured, served["launches"], dense_launches, engine_launches,
        trained["launches"], k1_paths, xlmr, evaluated["launches"],
        ckpt["launches"], served_pruned, frontier, examples, decoder,
        moe, train_decoder, recsys, dry, sharded,
        xlmr["sharded_engine"])}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
