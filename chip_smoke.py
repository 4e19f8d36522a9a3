"""Smoke test of the PyTorch + CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Builds the port's twenty-three CUDA kernels (twenty sources) from
src/repro_torch/csrc, then:

  1. kernels: each kernel against its plain PyTorch version on the card, at
     the main path's shapes (TPC-C: N = 2,450,808 records, T = 128 lanes,
     K = 64 slots; YCSB: N = 10M, K = 16; G = 2; version rings of D = 4),
     over every flag combination, with hot, duplicated, masked (key -1)
     and stale-tag inputs, masks with and without live ops, and a wave
     whose claim tag has its top bit clear; the scan kernel with point
     ops among intervals that cross the table's end, fine and coarse,
     buckets of 8 and 1; the ring kernels with empty slots, reclaimed
     snapshots, stamps on both sides of 2**31, rings that wrap and D = 1.
     Outputs and updated tables must be bit-identical.  Each is timed with
     CUDA events (warm-up, then the median of 30 calls queued behind a
     device sleep so that host overhead stays out of the device time)
     beside its plain version and, where one PyTorch call computes the
     same function, that call; the four scan and ring kernels on a wave
     drawn by the scan-configured workload generator.  The sharded
     engine's kernels at its own shapes (256 lanes of 16 slots, x 2 with
     scans, routed to 1 and 8 shards at DistConfig's capacity, a forced
     drop, a skewed wave, masked owners; verdict rows of ragged length
     and words with bit 31 set), and wave_commit on rows of up to 32,768
     ops; these timed at the one-card shapes.  The backend op probe at
     both shapes, fine and coarse, on keys that are masked, past the
     table's end or hot, over unclaimed, stale and live words, at both
     waves.  segment_count's edges on both of its kernels (the
     shared-memory hash up to 8,192 ops, the all-pairs count above): one
     op, every op masked out or in, every op on one cell, a Zipf-hot
     YCSB wave, cells near 10M x 2, G = 1 with zero groups, n = 8,192,
     8,193 and 20,000; the Zipf wave and n = 20,000 timed too.
     iterate_validate's edges (iterate_validate_cases): walks of 1, 31,
     32, 33, 128, 129 and 208 rows, fine and coarse, B = 8 and 1, G = 1
     to 3, a stronger claim only in a span's last row and one past an
     interval's width, a warp of scans only and one with nothing to
     walk, keys -1 and past the end, extents <= 0, both tag halves;
     wave_commit's (wave_commit_cases): K = 1, 33 and 1,024, rows of
     2,048 to 32,768 ops, T above any co-resident grid, every op on one
     cell, masked keys and groups, every optional mask, bump on and
     off; validate's two-channel form (validate_pair_cases): the
     multi-version waves' disjoint masks, overlapping masks, one channel
     alone, none, fine and coarse, G = 1 to 3, keys -1 and past the end,
     groups past G, ties, both tag halves; validate with the
     multi-version wave's claim installs (validate_install_cases): the
     waves' masks, ops with both, one or neither install and check,
     installs alone, checks alone, nothing, duplicate cells in both
     tables, fine and coarse, G = 1 to 3, and a wave of more ops than an
     H100 keeps co-resident threads, verdicts and both tables compared;
     mv_install's (mv_install_cases): D = 4 and 1, G = 1 to 3, duplicate
     writers of a record in one group and in several, keys and groups out
     of range, heads at D - 1, D, D + 3 and -1, empty and full masks,
     every op on one record, stamps on both sides of 2**31, and a wave
     past the kernel's one-op-a-thread capacity; route_pack's
     (route_pack_cases): M off the 256-op tile, one op and none, n_dest
     1, 3, 8 and 1,024, cap 0, 16 and DistConfig's, skewed overflows, W
     1 to 8, more tiles than resident blocks, and a buffer of more than
     2**31 words; ts_install_max's folded form (ts_install_cases):
     TicToc's three installs with the chained stamps computed in the
     kernel, masks half, full and empty, fine and coarse extensions, G =
     1 to 3, keys -1 and past the end, groups past G, words and stamps on
     both sides of 2**31 and past 2**32, and a wave past the resident
     grid, both tables compared; claim_probe on
     one and two tables (claim_probe_cases): masks half, full and empty,
     fine and coarse, G = 1 to 3, both tag halves, duplicate cells, keys
     -1 and past the end, groups past G, a tie, and a wave past the
     kernel's co-resident grid, answers and tables compared; ts_gather's
     TicToc form (ts_gather_cases: both tables to commit_ts and
     ext_need): fine and coarse, G = 1 to 3, K = 1, 40, 300 (wider than
     the block) and 1,030, rts words of 0xFFFFFFFF (a write's rts + 1
     wraps to 0), overlapping and empty masks, scan extents, keys -1 and
     past the end, groups past G; the ring folds of validate and of
     claim_probe's verdict form (ring_fold_cases): D = 4 and 1, G = 1 to
     3, empty slots, records all empty or all newer than the snapshot
     (reclaimed), stamps on both sides of 2**31, and a wave past the
     resident grid, validate's verdicts and ok, claim_probe's verdict
     words and both tables compared; iterate_validate's bump form
     (bump_fold_cases: the phantom pass and the version bumps in one
     launch): K = 1, 16, 64, 160, 1,024 and 1,030, lanes with a point
     conflict only, a phantom only, neither and both, every write
     masked, keys -1 and past the end, groups past G, G = 1 to 3,
     duplicate write cells across lanes, wts words at 0xFFFFFFFF (the
     bumps wrap), fine and coarse, both tag halves and a wave past the
     resident grid, verdicts and wts compared; validate_dual's install
     form (dual_install_cases: AutoGran's write-claim install and both
     verdicts in one cooperative launch): its masks, overlapping ones,
     installs alone, checks alone, none, G = 1 to 3, K = 1, 40 and
     1,030, duplicate cells, a tie, both tag halves and a wave past the
     resident grid, both verdicts and the table compared.  validate is
     timed on the
     masks the MVCC and MV-OCC waves build (TPC-C and the multi-version
     YCSB mix) as one launch that installs both claim tables, checks and
     reads the ring, beside the same call without the ring and beside
     the install form and mv_gather, the launches the waves made before;
     TicToc's observation as one ts_gather launch on a main-path TicToc
     wave, fine and coarse, beside the one-table launch twice and the
     torch arithmetic; TicToc's three installs as one ts_install_max
     launch, with the fine and the coarse extension, beside the one-table
     launch three times; claim_probe (one cooperative launch) on one
     table and on two tables beside two calls; the bump form on the scan
     wave beside the chain it replaces (iterate_validate, the OR, any,
     NOT and mask, commit_install) and the install form on an AutoGran
     wave of the main path's workload beside its chain (two priority
     copies, claim_scatter, validate_dual).  The sharded wave's folded
     verdict forms
     (verdict_fold_cases): wave_commit writing the packed verdict words,
     claim_probe's verdict form on one table and on two with the ring,
     iterate_validate ORing into bit 0 and bit 1 of those words,
     commit_install and mv_install reading commit words, and the sender's
     gather forms of verdict_unpack (at the routing coordinates) and
     verdict_pack (through the lane channel), each against the chain of
     plain ops it replaces, bit-identical: cap % 16 of 0 and 8 and cap =
     8 (words straddling rows), 1, 3 and 8 rows, the one-card row (16,384
     ops) and scan row (32,768), rows of empty cells, all-conflict rows,
     scan fragments sharing words, and 8 rows of 40,968 ops past the
     resident grid; each timed at the one-card shapes beside the chain it
     replaces and the claim and install launches beside the same call
     without the words.
     Every wave kernel reads the wave (and the ring stamps derived from
     it) from device memory; a case's int wave is copied there once.
     apply_values, the port's own kernel (the tracked values' serial
     replay and the ring's copy-forward; no TPU kernel), against its
     plain replay, bit for bit, at TPC-C's shape (T 128, K 64, N
     2,450,808, C 4) and YCSB's (K 16, N 10M, C 10) flat, at TPC-C's into
     a ring of D = 4 with the copy-forward (head_old), and at 512 lanes
     of TPC-C's width, past the one-launch form (the grid form): hot
     records, masked keys and keys past the table, uncommitted lanes,
     every op on one cell (across lanes and within them), each lane's ops
     on four cells of its own, nothing committed, signed priorities with
     ties and the int32 extremes, columns and ring heads from one past
     the negative end to one past the end, non-integer deltas; one op, a
     lane of 1,030 ops, rings of D = 1 and 2,048 lanes of 2 ops; each
     timed form beside its bound and its plain replay;
  2. the main path on TPC-C (full scale, T = 128, 200 waves) through the
     benchmark CLI's grid runner: OCC, TicToc, 2PL, SwissTM and Adaptive
     x coarse and fine, plus AutoGran coarse, with the launch counters set
     to 0 just before and read just after.  Every kernel of each
     mechanism must have launched, aborts must sum over causes, every
     lane-wave must commit or abort, every TicToc wave must launch
     ts_install_max once (its three installs) and ts_gather once (its two
     reads and commit_ts), every AutoGran wave validate_dual once (its
     write claims installed in it), commit_install once (its bumps) and
     claim_scatter never, and OCC-fine must beat
     OCC-coarse and TicToc-coarse (the paper's quickstart ordering), and
     AutoGran-coarse must beat OCC-coarse (the paper's section 5
     proposal);
  3. the same main path on YCSB (10M keys, theta 0.9, 50% writes);
  4. the unfused route (claim_probe + commit_install) of the five
     probe-family mechanisms on TPC-C at full scale, counters reset just
     before: claim_probe must launch once a wave (both claim tables in
     one launch on 2PL's and Adaptive's dual waves), commit_install too
     where the mechanism bumps, wave_commit never, and each run must end
     with the fused run's results;
  5. fused = unfused on the card: one set of CPU-made draws through both
     routes, integer and float state bit-identical;
  6. the scan path at full size: TPC-C with scan_len 200 (Stock-level
     examines ~200 items, TPC-C 2.8) and YCSB workload E (10M keys,
     theta 0.9, scanproportion 0.95, maxscanlength 100), T = 128, 200
     waves: the five probe-family mechanisms and MVCC/MV-OCC x coarse and
     fine, plus AutoGran.  MVCC must see no phantom, coarse must see at
     least fine's phantoms for OCC, TicToc and MV-OCC, every
     mechanism's kernels (iterate_validate included) must have launched,
     iterate_validate once a wave but MVCC's (the bumping waves in its
     bump form, their version bumps inside it), validate_dual once an
     AutoGran wave, commit_install and claim_scatter never;
  7. the multi-version path at full size: MVCC/MV-OCC x coarse and fine on
     TPC-C, and OCC/MVCC/MV-OCC on YCSB with 80% writes and 20% read-only
     transactions (benchmarks/abort_rates.py): read-only lanes never
     abort under MVCC/MV-OCC and do under coarse OCC; one MVCC run whose
     snapshots are 8 waves old (beyond the ring's 4) aborts as stale;
     every MVCC and MV-OCC wave launches validate (both claim installs,
     the check and the ring read) once, mv_install once and
     claim_scatter and mv_gather never;
  8. fused = unfused again with scans on (the fused route's bumps move
     out of wave_commit into iterate_validate's bump form, the unfused
     route's stay in commit_install);
  9. cross-device identity: one set of draws made on the CPU, run through
     the wave step on the card (kernels) and on the CPU (plain versions),
     for every mechanism on the point mix, one scan configuration per
     mechanism and the MV configurations; integer state (the version ring
     included) must be bit-identical, lane_time within rtol 1e-5 and the
     heats within rtol 1e-6;
 9b. the backend ops without an engine caller: probe on a table
     wave_commit has just installed into (TPC-C shape), mv_gather on a
     ring mv_install has just published that wave's writes into, at the
     next wave's snapshot, and claim_scatter of the next wave's claims
     into a copy of that table: one launch each, equal to the plain
     versions, every installed claim and every published version seen;
 9c. examples/quickstart_torch.py's main as it ships (TPC-C 8 warehouses,
     scale 0.5, T = 96, 200 waves): OCC-fine beats OCC-coarse and
     TicToc-coarse;
 9d. fig3's grid through the grid runner (the port's sweep): TPC-C scale
     1.0, OCC, TicToc, 2PL and MV-OCC x coarse and fine x lanes 64, 96,
     128 (one bucket: 64 and 96 run padded to 128), 200 waves; every
     point's commits + aborts == T x waves, causes sum to aborts, every
     kernel launched; fig3's ratio lines printed beside the paper's, and
     OCC-fine@96 must beat TicToc-coarse@96;
 9e. cross-device identity of a padded point (T = 96 of 128) and of one
     open-loop configuration (queue, counters and histogram included);
 9f. the open loop: YCSB (10M keys, theta 0.9, 50% writes), OCC and MVCC x
     coarse and fine, T = 128, 200 waves, arrivals at 96 a wave into a
     queue of 512 with 8 incarnations: admitted == commits + queued +
     inc_drops, offered == admitted + arrival_drops, reenq_drops == 0 and
     inc_cap aborts == inc_drops, exactly; goodput and p50/p99
     time-to-commit printed;
 9g. sync-free waves (sync_free_path): every mechanism x coarse and fine
     on TPC-C and YCSB point, TPC-C scan_len 200 with OCC, AutoGran and
     MVCC, YCSB workload E with OCC, the unfused route with OCC, 2PL and
     Adaptive, and the open step (YCSB, OCC and MVCC, rate 96, queue
     512), T = 128: two eager waves of engine.draw_wave (the draws and the
     step), then three under torch.cuda.set_sync_debug_mode("error") and
     torch.profiler with no host-to-device or device-to-host copy and no
     stream or device synchronize among them; the wave index advanced on
     the device; six tracked configurations (track_conflicts and the
     per-wave timeline's writes among the guarded waves: OCC, TicToc,
     AutoGran, MVCC on TPC-C point, OCC on TPC-C scans, MVCC open-loop);
     six with tracked values (the apply_values replay; under MVCC and
     MV-OCC the ring's head copy and its replay with the copy-forward
     too: OCC, TicToc,
     AutoGran, MVCC on TPC-C point, MV-OCC on YCSB point, OCC
     open-loop);
 9h. observability (observability_path): OCC fine, TicToc, MVCC and
     AutoGran coarse on TPC-C (8 warehouses, scale 1.0, T = 128, 200
     waves) through engine.run with track_conflicts off and on: the runs
     identical but for the conflict tables, per-wave series included,
     the tracked run launching exactly one commit_install, one
     segment_count and one ts_install_max more a wave, with hot records;
     txn_bench --trace over OCC and TicToc x coarse and fine: the Chrome
     trace valid with one slice a wave, the rows' cost-model columns
     those of analysis/txn_cost.py; then tracked OCC fine and TicToc
     coarse on the card and the CPU from the same draws (TPC-C scale 0.1,
     30 waves): conflict tables, hot_records and per-wave integer series
     bit-identical, per-wave simulated µs within rtol 1e-5;
 9i. tracked values (values_path): OCC fine, TicToc coarse, 2PL fine,
     AutoGran coarse, MVCC coarse and MV-OCC fine on TPC-C (8
     warehouses, scale 1.0) and YCSB 10M, T = 128, 200 waves, untracked
     and tracked from one seed: commits, counters and every table
     identical, the tracked run launching apply_values once a wave (twice
     under MVCC and MV-OCC) and nothing else more; TPC-C's warehouse and
     district YTD each summing to the committed payments exactly; under
     MVCC and MV-OCC the ring's newest versions equal to the values, and
     after every wave each op of the waves 0, 1, 2, 3 and 5 back reading
     its cell at that wave's snapshot (mvstore.snapshot_values, through
     mv_gather): an ok read equals the value after that wave, bit for
     bit.  Then tracked OCC fine, TicToc coarse, MVCC coarse and MV-OCC
     fine on the card and the CPU from the same draws (TPC-C scale 0.1,
     30 waves): values and ring values bit-identical;
 10. the sharded engine (core/distributed.py) on a one-rank NCCL group:
     YCSB and TPC-C at the main path's sizes and YCSB workload E, 256
     lanes, 200 waves, OCC/MVCC/MV-OCC x coarse and fine and OCC fine
     unfused (workload E: OCC and MV-OCC fine).  Every op of the
     mechanism launches its kernel, claim_probe once a wave where the
     wave calls it (both claim channels and the ring read of an MV wave
     in one launch; mv_gather never), the claim launch (writing the
     packed verdicts), the install launch (reading the commit words),
     verdict_unpack and verdict_pack once a wave each (the sender's
     gather forms; the owner launches neither),
     causes sum to aborts, MVCC sees no phantom, MVCC/MV-OCC abort no
     read-only lane, the collective carries the modelled wire bytes, each
     run commits exactly the lanes the local validator commits on the
     same draws and prio (tables too), and the fused and unfused OCC
     routes agree; waves/s, device operations per wave and collective
     bytes per wave are printed;
 11. the sharded engine on the card (NCCL) against the CPU (gloo) for 30
     waves at reduced sizes: commit masks, tables and stats bit-identical;
 11b. the sharded open loop (core/distributed.run_open_loop, depth 1) on
     the one-rank NCCL group: YCSB 10M, 256 lanes, OCC and MVCC x coarse
     and fine, 192 Poisson arrivals a wave into a queue of 1,024 with 8
     incarnations and 32 time-to-commit bins, 200 waves: the conservation
     identities exact, route_pack, the claim and install kernels,
     verdict_pack and verdict_unpack once a wave each; goodput, p50/p99
     time-to-commit and waves/s printed.  Then OCC fine and MVCC coarse
     wave by wave on the card and on the CPU through a gloo group (YCSB
     100k keys, 30 waves): commit masks, stats, queue state and tables
     bit-identical;
 11c. the software-pipelined sharded wave, forced to depth 2 on the
     one-rank NCCL group (core/distributed._pipelined_run; DistConfig
     keeps one shard at depth 1): every configuration of 10, 200 waves,
     commit masks, stats and tables bit-identical to the synchronous
     runner's run of 10, every kernel of the mechanism launched once a
     step ("cuda"), n_waves + 3 exchanges of the fused buffer; waves/s
     and device operations a wave printed beside depth 1's.  The
     pipelined open loop (core/distributed._open_loop at depth 2) with
     11b's settings: the conservation identities exact, every kernel once
     a step; with max_incarnations=0 every counter and the histogram equal
     to depth 1's.  Both pipelined runners on the card and on the CPU
     (gloo) for 30 waves at 11's reduced sizes, wave by wave; then a (1,
     1) axis-wise mesh (launch/mesh.init_shards(mesh_shape=...)), one
     exchange per axis, equal to the flat exchange at twice its bytes;
 12. the scaling rows of repro_torch.launch.txn_scaling (the local anchor,
     sharded OCC and MVCC on the JAX benchmark's draws, and the open-loop
     rows: OCC and MVCC x coarse and fine behind the admission rings);
 13. LM serving: flash_attention, rglru and rwkv6 against their plain
     versions at the full-width prefill shapes (recurrentgemma-9b: B 4,
     S 3,072, D 4,096; Hq 16 over Hkv 1, D 256, window 2,048; rwkv6-3b:
     B 4, H 48, S 3,072, Dk = Dv = 64), at S = 1 and at edge cases
     (ragged lengths, sk_valid < Sk, sq_valid < Sq, GQA ratios 1 to 16,
     every head width, float32 and bfloat16; the bfloat16 tensor-core
     kernel at Sq = 65 and Sq = 1 with D 256, a window of 16 inside one
     key tile, GQA 16 with sk_valid < Sk, D 16 and D 32 with rows that see
     no key; rglru's staged walk at a = 1, at log_a <= -20, with S and D
     off its tiles, rows that are not 16-byte aligned, and fewer channels
     than a block; rwkv6's chunked kernel on the model's decay
     distribution at the prefill shape, with w = 0 and 1 exactly, at S =
     63 (the recurrent kernel), 64, 65 and 1,000, and at Dk 16, 32 and
     128, each case's line naming the rwkv6 kernel that served it):
     float32 within rtol 1e-5 / atol 1e-5, bfloat16 within 2 ulps; each
     timed at the prefill shape beside its plain version, its bound and,
     for flash_attention, F.scaled_dot_product_attention with the same
     mask.  Then
     recurrentgemma-9b and rwkv6-3b at full width (random bf16 weights
     from a seed) through repro_torch.launch.serve.serve: 4 requests of
     3,072-token prompts, 32 tokens each, the launch counters set to 0
     just before and read just after: per prefill one flash_attention per
     attention layer (12) and one rglru (26) or rwkv6 (32) per recurrent
     layer, per decode step the recurrent ones only.  The same weights
     and prompt through the plain route, and both routes on the float32
     model of the same weights: the float32 routes' last-position logits
     of the prefill and of the first decode step within relative L2 1e-2;
     the bf16 kernel route at most twice as far from the float32 plain
     route as the bf16 plain route (plus 1e-2); the bf16 routes' distance
     printed beside that bound (bf16 rounding of the residual stream puts
     two correct evaluations farther apart).  The bf16 plain route also
     decodes its own 32 greedy tokens; how many of each request's tokens
     equal the kernel route's, up to the first difference, is printed.
     qwen2-7b (the dense family: 28 layers, GQA 32/4 at D 128, causal)
     the same way: 28 flash_attention launches a prefill.
 14. flash_attention's backward (flash_attention_backward, the port's own
     kernel) and its forward's lse against their plain versions
     (flash_backward_phase): the training shape (B 1, Hq 32 over Hkv 4,
     S 4,096, D 128, causal, bf16), recurrentgemma-9b's training shape
     (B 1, Hq 16 over Hkv 1, S 4,096, D 256, causal, window 2,048, bf16)
     and the same at S 3,072, and FLASH_CASES' decode shape and edges
     (sq_valid, sk_valid, rows without keys, D 16 and 32, rep 1,
     float32): dq, dk, dv within relative L2 1e-4 (float32) / 1e-2
     (bf16), lse within 1e-4 + 1e-5 |lse| and -inf on the same rows, the
     output with lse equal bit for bit to the one without; bf16 edges of
     the tensor-core backward at D 128 and D 256 (GQA 8 / 16 with a
     window of 100 at 300 rows, Sq 100 < Sk 260 with sk_valid 230, rep 1
     not causal, rows that see no key); two calls give the same bits.
     The forward with lse and the backward timed at both training shapes
     beside their bounds, the plain backward, SDPA's forward + backward
     with the same boolean mask (and the backend it ran) and with
     is_causal and enable_gqa, and the per-launch split (delta, dkdv, the
     rep sum, dq) from the profiler;
 15. the recurrences' backwards (recurrent_backward_phase; rglru_backward
     and rwkv6_backward, kernels of the port's own) against their plain
     versions at the training shapes (recurrentgemma-9b: B 1, S 4,096,
     D 4,096; rwkv6-3b: B 1, H 48 as the trained model pads its heads,
     and H 40, S 4,096, Dk = Dv = 64; bf16) and edges: rglru at a = 1
     exactly (its dlog_a infinite or NaN on the plain version's elements)
     and log_a <= -20, S = 1, 63, 65 and 1,000, D off the 64-channel
     block with and without 16-byte rows, h0 and dh_last given and
     absent, float32; rwkv6 on both routes (bf16 with S >= 64 split in
     time, float32 and S < 64 recurrent) at w = 0 and 1 exactly and at
     1.9e-24, S = 1, 63, 64, 65, 128, 1,000 and 4,097, Dk 16, 32 and 128,
     Dv != Dk, s0 and ds_last given and absent, bf16 and float32: every
     gradient within relative L2 1e-4 (float32) / 1e-2 (bf16), the
     gradients that are bit-identical named by route; two calls give the
     same bits; each timed at its training shape (rwkv6 at H 48 and H 40)
     beside its bound and its plain version, rwkv6's per-launch split
     (the chains, the chunk pass, du's sum) from the profiler; with
     --parent the parent's recurrent rwkv6 backward in turns;
 16. training (lm_train_path) of all three families at published widths,
     random weights from a seed, bf16 with float32 master and moments,
     n_micro 4, remat: qwen2-7b cut to 8 layers, recurrentgemma-9b to 6
     (two (rec, rec, attn) blocks) and rwkv6-3b at its 32 layers, each
     depth the deepest whose reckoned peak (TRAIN_FIT_GIB) fits.  One
     microbatch's gradients through the kernel and plain routes on the
     float32 model (loss within rtol 1e-5, every gradient within relative
     L2 1e-3, or, where float32 order alone moves it further, at most
     twice as far from the float64 plain route as the float32 plain
     route is) and on the bf16 model (every kernel-route gradient at most
     twice as far from the float32 plain gradients as the bf16 plain
     route's, + 1e-2), at TRAIN_GRAD_LAYERS' depth (the plain route's
     per-token loops are slow); then 2 steps of 4 x 4,096 tokens through
     launch.train.run_supervised, the launch counters set to 0 just
     before and read just after: per layer and microbatch, its kernel
     (flash_attention, rglru or rwkv6) twice (forward and remat's
     recompute) and its backward once, nothing else, nothing on the plain
     route; step ms, tokens/s, peak GiB and a profiled step (the
     backwards' share of device-busy time); three steps on one repeated
     batch lower the loss; the smoke config's restart through the kernels
     (one injected failure; the checkpoint restores bit for bit).

Prints the card's name and power limit, a ``{"kernels": [...]}`` JSON line
and, last, ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; without CUDA, or without the repository beside it, it exits
non-zero before printing a result.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and the
# non-tensor-core float32 rate, used as the rate of the integer compares.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

TPCC_N, YCSB_N = 2_450_808, 10_000_000
SHAPES = {"tpcc": (TPCC_N, 2, 128, 64), "ycsb": (YCSB_N, 2, 128, 16)}
WAVES = 200
LANES = 128
#: Global lanes of the sharded engine's benchmark (benchmarks/txn_scaling.py)
#: and of the sharded phase.
DIST_LANES = 256
MV_DEPTH = 4
#: The scan path's workload settings: TPC-C's Stock-level window and YCSB
#: workload E (scanproportion 0.95, maxscanlength 100).
SCAN_KW = {"tpcc": dict(scale=1.0, scan_len=200),
           "ycsb": dict(n_keys=YCSB_N, theta=0.9, scan_frac=0.95,
                        scan_len=100)}

KERNEL_META = {
    "wave_commit": ("src/repro_torch/csrc/wave_commit.cu",
                    "src/repro/kernels/wave_commit.py:254"),
    "segment_count": ("src/repro_torch/csrc/segment_count.cu",
                      "src/repro/kernels/segment_count.py:39"),
    "ts_gather": ("src/repro_torch/csrc/ts_gather.cu",
                  "src/repro/kernels/ts_gather.py:42"),
    "ts_install_max": ("src/repro_torch/csrc/ts_install.cu",
                       "src/repro/kernels/ts_install.py:43"),
    "commit_install": ("src/repro_torch/csrc/occ_commit.cu",
                       "src/repro/kernels/occ_commit.py:37"),
    "claim_scatter": ("src/repro_torch/csrc/claim_scatter.cu",
                      "src/repro/kernels/claim_scatter.py:44"),
    "validate_dual": ("src/repro_torch/csrc/occ_validate.cu",
                      "src/repro/kernels/occ_validate.py:122"),
    "claim_probe": ("src/repro_torch/csrc/claim_probe.cu",
                    "src/repro/kernels/claim_probe.py:82"),
    "probe": ("src/repro_torch/csrc/claim_probe.cu",
              "src/repro/kernels/occ_validate.py:155"),
    "validate": ("src/repro_torch/csrc/occ_validate.cu",
                 "src/repro/kernels/occ_validate.py:86"),
    "iterate_validate": ("src/repro_torch/csrc/iterate_validate.cu",
                         "src/repro/kernels/iterate_validate.py:122"),
    "mv_gather": ("src/repro_torch/csrc/mv_gather.cu",
                  "src/repro/kernels/mv_gather.py:64"),
    "mv_install": ("src/repro_torch/csrc/mv_install.cu",
                   "src/repro/kernels/mv_install.py:60"),
    "route_pack": ("src/repro_torch/csrc/route_pack.cu",
                   "src/repro/kernels/route_pack.py:49"),
    "verdict_pack": ("src/repro_torch/csrc/verdict_pack.cu",
                     "src/repro/kernels/verdict_pack.py:50"),
    "verdict_unpack": ("src/repro_torch/csrc/verdict_pack.cu",
                       "src/repro/kernels/verdict_pack.py:65"),
    # No TPU kernel: the JAX package's serial replay is a lax.scan.
    "apply_values": ("src/repro_torch/csrc/apply_values.cu",
                     "src/repro/core/engine.py:95"),
}
#: The other call forms the kernel phase times beside a kernel's main-path
#: form, listed under "forms" in the kernels line: ts_gather's TicToc form
#: coarse and the one-table gather, ts_install_max's three installs with
#: the coarse extension and the one-table install, validate's ring form on
#: MVCC's masks, claim_probe on two tables, iterate_validate's bump form
#: (the scan waves' phantom pass and bumps), validate_dual's check alone
#: (its main-path form is AutoGran's install form).
KERNEL_FORMS = {"ts_gather": ("ts_gather_coarse", "ts_gather_one"),
                "ts_install_max": ("ts_install_max_coarse",
                                   "ts_install_max_one"),
                "validate": ("validate_mvcc",),
                "claim_probe": ("claim_probe_pair",),
                "iterate_validate": ("iterate_validate_bump",),
                "validate_dual": ("validate_dual_check",),
                "apply_values": ("apply_values_ycsb", "apply_values_ring",
                                 "apply_values_grid")}
#: The folded verdict forms of the sharded wave, timed at the one-card
#: sharded shapes (verdict_fold_timings) and listed under "forms" too:
#: the owner's claim launches writing the packed words, the scan check
#: ORing into them, the installs reading the commit words, and the
#: sender's gather forms of verdict_unpack and verdict_pack.
DIST_FORMS = {"wave_commit": ("wave_commit_pack",),
              "claim_probe": ("claim_probe_verdict",
                              "claim_probe_verdict_ring"),
              "iterate_validate": ("iterate_validate_words",),
              "commit_install": ("commit_install_words",),
              "mv_install": ("mv_install_words",),
              "verdict_pack": ("verdict_pack_gather",),
              "verdict_unpack": ("verdict_unpack_gather",)}
#: The kernels that only the sharded engine launches; the kernel phase
#: times them at the sharded wave's shapes.
DIST_KERNELS = ("route_pack", "verdict_pack", "verdict_unpack")
#: The kernels each mechanism's (fused) wave launches on the point mix.
#: The MV waves read the ring inside their validate launch: no mv_gather;
#: AutoGran installs its write claims inside its validate_dual launch: no
#: claim_scatter.
_PROBE_OPS = ("wave_commit", "segment_count")
_MV_OPS = ("validate", "mv_install", "segment_count")
MECH_OPS = {"occ": _PROBE_OPS,
            "tictoc": _PROBE_OPS + ("ts_gather", "ts_install_max"),
            "2pl": _PROBE_OPS, "swisstm": _PROBE_OPS, "adaptive": _PROBE_OPS,
            "autogran": ("validate_dual", "commit_install", "segment_count"),
            "mvcc": _MV_OPS, "mvocc": _MV_OPS}


def mech_ops(cc: str, scans: bool) -> tuple:
    """The kernels a mechanism's fused wave launches.  With scans every
    mechanism but MVCC adds iterate_validate, and AutoGran bumps inside
    it (its bump form, as the bumping probe-family mechanisms do), so it
    drops commit_install."""
    ops = MECH_OPS[cc]
    if scans and cc != "mvcc":
        ops = ops + ("iterate_validate",)
        if cc == "autogran":
            ops = tuple(op for op in ops if op != "commit_install")
    return ops

PROBE_FAMILY = ("occ", "tictoc", "2pl", "swisstm", "adaptive")
#: One granularity per probe-family mechanism for the unfused phases.
UNFUSED = (("occ", 1), ("tictoc", 0), ("2pl", 0), ("swisstm", 1),
           ("adaptive", 0))
#: A wave whose claim tag 0xFFFF - wave has its top bit clear.
HIGH_WAVE = 40_000
#: The abort-cause code of a lost interval validation (core/types.py).
CAUSE_PHANTOM = 6
#: Cross-device configurations (cc, granularity, fused): every mechanism
#: on the point mix, one scan configuration per mechanism.
POINT_CONFIGS = (("occ", 1, True), ("tictoc", 0, True), ("2pl", 0, True),
                 ("swisstm", 1, True), ("adaptive", 1, True),
                 ("autogran", 0, True), ("adaptive", 0, False),
                 ("mvcc", 1, True), ("mvocc", 0, True))
SCAN_CONFIGS = (("occ", 0, True), ("tictoc", 1, True), ("2pl", 0, True),
                ("swisstm", 1, True), ("adaptive", 0, True),
                ("autogran", 0, True), ("mvcc", 0, True), ("mvocc", 1, True),
                ("2pl", 1, False))


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------------ timing
def time_ms(fn, dev, n=30, warmup=5) -> float:
    """Median milliseconds of one call of ``fn`` on ``dev``."""
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)
    torch.cuda.synchronize(dev)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    # Queue every call behind a device sleep, so calls that do not wait
    # for the host run back to back and the events measure device time.
    torch.cuda._sleep(50_000_000)
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize(dev)
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    tb, to = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


# ------------------------------------------------------------------ inputs
def _words(x: torch.Tensor) -> torch.Tensor:
    from repro_torch.core.claimword import to_i32
    return to_i32(x.to(torch.int64))


def make_tables(N, G, wave, dev, seed):
    """claim_w, claim_r, wts, ts-table on ``dev``: claim words of stale
    waves, the empty word and a few live words of this wave; timestamps
    with some at the top of the uint32 range (the bump wraps)."""
    from repro_torch.core.claimword import inv_wave
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def claims():
        old = wave - torch.randint(1, 4, (N, G), generator=g, device=dev)
        inv = 0xFFFF - (old.clamp(min=0) & 0xFFFF)
        words = (inv << 16) | torch.randint(0, 1 << 16, (N, G), generator=g,
                                            device=dev)
        pick = torch.rand((N, G), generator=g, device=dev)
        live = (inv_wave(wave) << 16) | torch.randint(
            0, 1 << 16, (N, G), generator=g, device=dev)
        words = torch.where(pick < 0.3, live, words)
        return torch.where(pick > 0.8, -1, _words(words)).to(torch.int32)
    wts = _words(torch.randint(0, 1 << 32, (N, G), generator=g, device=dev))
    ts = torch.randint(0, 1 << 20, (N, G), generator=g, device=dev,
                       dtype=torch.int32)
    return claims(), claims(), wts, ts


def make_ops(N, G, T, K, dev, seed):
    """keys/groups/prio/masks of one wave: hot keys (a few records many
    ops hit), duplicates and masked ops (key -1)."""
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, N, 8)
    keys = rng.integers(0, N, (T, K))
    pick = rng.random((T, K))
    keys = np.where(pick < 0.3, hot[rng.integers(0, 8, (T, K))], keys)
    keys = np.where(pick > 0.9, -1, keys).astype(np.int32)
    groups = rng.integers(0, G, (T, K)).astype(np.int32)
    prio = np.broadcast_to(((63 << 10) | rng.permutation(T))[:, None],
                           (T, K)).astype(np.int32)
    masks = [rng.random((T, K)) < p for p in (0.5, 0.5, 0.6, 0.4, 0.5, 0.05)]
    vals = rng.integers(0, 1 << 32, (T, K), dtype=np.uint64).astype(
        np.uint32).view(np.int32)

    def d(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (d(keys), d(groups), d(prio), [d(m) for m in masks], d(vals))


# ------------------------------------------------------------ kernel phase
def _diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest absolute difference (uint32 words compared as unsigned)."""
    if a.dtype == torch.int32:
        from repro_torch.core.claimword import u32
        a, b = u32(a), u32(b)
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


class KernelCheck:
    def __init__(self, name):
        self.name, self.max_err, self.cases, self.equal = name, 0.0, 0, True

    def compare(self, got, want):
        for a, b in zip(got, want):
            if a is None:
                continue
            self.max_err = max(self.max_err, _diff(a, b))
            self.equal = self.equal and torch.equal(a, b)
        self.cases += 1


def _distinct(keys, groups, mask, G, N):
    """Distinct live (record, group) cells among the masked ops."""
    ok = mask & (keys >= 0) & (keys < N)
    return int(torch.unique(keys[ok].long() * G + groups[ok].long()).numel())


def _distinct_rows(keys, mask, N):
    """Distinct live records among the masked ops."""
    return int(torch.unique(keys[mask & (keys >= 0) & (keys < N)]).numel())


def zipf_keys(rng, n_keys, theta, shape):
    """YCSB's Zipfian key draw (rank r with weight r**-theta, rank 1 the
    hottest key 0), by the inverse of the continuous power law's CDF."""
    a = 1.0 - theta
    u = rng.random(shape)
    r = (u * ((n_keys + 1.0) ** a - 1.0) + 1.0) ** (1.0 / a)
    return np.minimum(r.astype(np.int64) - 1, n_keys - 1)


def segment_count_cases(seed=31):
    """segment_count's edge cases, made with numpy from ``seed``: [(label,
    keys int32, groups int32, G, mask bool)].  One op; every op masked out
    and every op masked in; every op on one cell; a Zipf-hot YCSB wave
    (10M keys, theta 0.9, 128 x 16); cells near 10M x 2; G = 1 with zero
    groups, as the engine calls it; n = 8,192 (the hash kernel's largest
    wave, keys -1 among the masked ops) and n = 8,193 and 20,000 (the
    all-pairs kernel)."""
    rng = np.random.default_rng(seed)

    def wave(shape, n_keys, G, p_mask=0.5, dup=0.3):
        keys = rng.integers(0, n_keys, shape)
        hot = rng.integers(0, n_keys, 8)
        keys = np.where(rng.random(shape) < dup,
                        hot[rng.integers(0, 8, shape)], keys)
        return (keys.astype(np.int32),
                rng.integers(0, G, shape).astype(np.int32), G,
                rng.random(shape) < p_mask)

    T, K = 128, 16
    z = zipf_keys(rng, YCSB_N, 0.9, (T, K)).astype(np.int32)
    near = (YCSB_N - 1 - rng.integers(0, 40, (T, K))).astype(np.int32)
    big = wave((128, 64), TPCC_N, 2)
    big_keys = np.where(rng.random((128, 64)) < 0.05, -1, big[0])
    ones = np.ones((T, K), bool)
    return [
        ("n=1", np.array([[7]], np.int32), np.array([[1]], np.int32), 2,
         np.array([[True]])),
        ("all masked out",) + wave((T, K), 1000, 2, p_mask=0.0),
        ("all masked in",) + wave((T, K), 1000, 2, p_mask=1.0),
        ("one cell", np.full((T, 64), 123_456, np.int32),
         np.ones((T, 64), np.int32), 2, np.ones((T, 64), bool)),
        ("zipf ycsb", z, rng.integers(0, 2, (T, K)).astype(np.int32), 2,
         rng.random((T, K)) < 0.5),
        ("cells near 10M x 2", near,
         rng.integers(0, 2, (T, K)).astype(np.int32), 2, ones),
        ("G=1 zero groups", z, np.zeros((T, K), np.int32), 1,
         rng.random((T, K)) < 0.7),
        ("n=8192", big_keys.astype(np.int32), big[1], 2, big[3]),
        ("n=8193",) + wave((3, 2731), 5000, 2),
        ("n=20000",) + wave((125, 160), 20000, 2, p_mask=0.7),
    ]


def segment_count_case_checks(check, dev):
    """segment_count against its plain version on segment_count_cases;
    returns timing rows of the Zipf wave (hash kernel, hot keys) and of
    n = 20,000 (all-pairs kernel)."""
    from repro_torch import kernels as K
    from repro_torch.kernels.segment_count import segment_count_plain
    timings = {}
    for label, keys, groups, G, mask in segment_count_cases():
        a = [torch.from_numpy(x).to(dev) for x in (keys, groups, mask)]
        check.compare([K.segment_count(a[0], a[1], G, a[2])],
                      [segment_count_plain(a[0], a[1], G, a[2])])
        if label in ("zipf ycsb", "n=20000"):
            n = keys.size
            cells = torch.where(a[2], a[0].long() * G + a[1].long(),
                                -1).reshape(-1)
            timings[f"segment_count {label}"] = dict(
                ms=time_ms(lambda: K.segment_count(a[0], a[1], G, a[2]),
                           dev),
                plain_ms=time_ms(lambda: segment_count_plain(
                    a[0], a[1], G, a[2]), dev),
                library_ms=time_ms(lambda: torch.unique(
                    cells, return_inverse=True, return_counts=True), dev),
                bound=bound_ms(n * (4 + 4 + 1 + 4), n * math.log2(n)))
    return timings


def claim_words(rng, N, G, wave, live_share):
    """uint32[N, G] claim words as a probe sees them: the empty word,
    words of the last three waves and a share of live words of ``wave``
    (never a newer wave: the monotone-tag precondition)."""
    def tag(w):
        return (0xFFFF - (w & 0xFFFF)).astype(np.uint64) << 16
    old = np.maximum(wave - rng.integers(1, 4, (N, G)), 0)
    stale = tag(old) | rng.integers(0, 1 << 16, (N, G)).astype(np.uint64)
    live = tag(np.full((N, G), wave)) | rng.integers(
        0, 1 << 16, (N, G)).astype(np.uint64)
    pick = rng.random((N, G))
    return np.where(pick < 0.2, 0xFFFFFFFF, np.where(
        pick < 0.2 + live_share, live, stale)).astype(np.uint32)


def _live_word(wave, prio):
    return np.uint32(((0xFFFF - (wave & 0xFFFF)) << 16) | prio)


#: The iterate_validate cases' ext_cap values: walks of 1, 31, 32, 33, 128
#: and 129 rows around the kernel's warp (32) and batch (128 rows), and
#: TPC-C's 200 (a coarse span of 208 at B = 8) and 208.
SCAN_EXT_CAPS = (1, 31, 32, 33, 128, 129, 200, 208)


def iterate_validate_cases(seed=41):
    """iterate_validate's edge cases, made with numpy from ``seed``:
    [(label, dict)] with the wrapper's arguments (``table`` and ``myprio``
    as uint32) and the flat indices of two planted ops.  For every ext_cap
    of SCAN_EXT_CAPS, fine and coarse, B = 8 and 1, waves whose claim tag
    has its top bit set (9) and clear (HIGH_WAVE) in turn, G = 2, and four
    more at G = 3 and G = 1: T = 4 lanes of K = 32 ops on N = 1,001 rows,
    one warp a lane:
      lane 0: every op a scan; op 0 (``last_row_op``) walks the whole span
        and its only stronger claim lies in the span's last row (weaker
        and equal claims before it); op 1 (``past_width_op``) has a
        stronger claim in the first row past its width but inside the
        span, which must not count;
      lane 1: no op needs a walk (check clear);
      lane 2: key -1 with check set, extents 0 and -5, intervals that
        cross the table's end, a key past it, a group out of range;
      lane 3: point ops (extent 1), every check set."""
    rng = np.random.default_rng(seed)
    from repro_torch.kernels.iterate_validate import scan_span
    N, T, K = 1001, 4, 32
    cases = []
    modes = ((True, 8), (True, 1), (False, 8), (False, 1))
    configs = [(e, f, B, 2) for e in SCAN_EXT_CAPS for f, B in modes] + [
        (129, True, 8, 3), (129, False, 8, 3), (33, True, 8, 1),
        (33, False, 1, 1)]
    for ci, (ext_cap, fine, B, G) in enumerate(configs):
        wave = 9 if ci % 2 == 0 else HIGH_WAVE
        span = scan_span(ext_cap, fine, B)
        share = min(0.3, 1.4 / (G * max(1.0, ext_cap / 2)))
        table = claim_words(rng, N, G, wave, share)
        keys = rng.integers(0, N, (T, K))
        hi = max(ext_cap, 2)
        ext = rng.integers(2, hi + 1, (T, K)) if ext_cap > 1 else \
            np.ones((T, K), np.int64)
        groups = rng.integers(0, G, (T, K))
        prio = rng.integers(0, 0xFFFF, (T, K))
        check = np.ones((T, K), bool)
        check[1] = False
        keys[1, rng.random(K) < 0.3] = -1
        keys[2] = np.where(rng.random(K) < 0.15, -1, keys[2])
        keys[2, :8] = [-1, 17, 23, N - 3, N - 1, N + 3, 40, N + 3]
        ext[2, :8] = [ext_cap, 0, -5, ext_cap, ext_cap, ext_cap, ext_cap, 1]
        groups[2, 6] = G
        check[2, 8:] = rng.random(K - 8) < 0.8
        ext[3] = 1
        # op 0: its walk covers the whole span [s, s + span) and only the
        # last row holds a stronger claim.
        s = 64
        keys[0, 0] = s if fine else s + B - 1
        ext[0, 0] = ext_cap
        prio[0, 0] = 0x8000
        g0 = groups[0, 0]
        stale = _live_word(max(wave - 2, 0), 0x0123)
        table[s:s + span] = stale
        weak = rng.random((span, G)) < 0.3
        table[s:s + span][weak] = [_live_word(wave, p) for p in
                                   rng.integers(0x8000, 0xFFFF, weak.sum())]
        table[s + span - 1, g0 if fine else G - 1] = _live_word(wave,
                                                               0x1234)
        # op 1: a stronger claim in the first row past its width.
        past = None
        s1 = 504
        e1 = max(1, ext_cap // 3)
        width = e1 if fine else -(-e1 // B) * B
        if width < span:
            past = 1
            keys[0, 1], ext[0, 1], prio[0, 1] = s1, e1, 0x8000
            table[s1:s1 + span] = stale
            table[s1 + width, groups[0, 1]] = _live_word(wave, 0x0042)
        cases.append((
            f"ext_cap={ext_cap} {'fine' if fine else 'coarse'} B={B} "
            f"G={G} wave={wave}",
            dict(table=table, keys=keys.astype(np.int32),
                 extents=ext.astype(np.int32),
                 groups=groups.astype(np.int32),
                 myprio=prio.astype(np.uint32), check=check, wave=wave,
                 fine=fine, bucket_size=B, ext_cap=ext_cap,
                 last_row_op=0, past_width_op=past)))
    return cases


def iterate_validate_case_checks(check, dev):
    """iterate_validate against its plain version on
    iterate_validate_cases; the planted ops must answer as planted."""
    from repro_torch import kernels as K
    from repro_torch.kernels.iterate_validate import iterate_validate_plain
    hits = []
    for label, c in iterate_validate_cases():
        a = [torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32
                              else x).to(dev)
             for x in (c["table"], c["keys"], c["extents"], c["groups"],
                       c["myprio"], c["check"])]
        args = (*a, c["wave"], c["fine"], c["bucket_size"], c["ext_cap"])
        got = K.iterate_validate(*args)
        check.compare([got], [iterate_validate_plain(*args)])
        flat = got.reshape(-1)
        if not bool(flat[c["last_row_op"]]) or (
                c["past_width_op"] is not None
                and bool(flat[c["past_width_op"]])):
            raise AssertionError(f"iterate_validate {label}: a planted "
                                 f"claim answered wrongly")
        hits.append(int(got.sum()))
    log(f"  iterate_validate edge cases: {len(hits)}, conflicts "
        f"{min(hits)}..{max(hits)} of 128 ops")


#: Threads an H100 holds on one SM, and its SMs: wave_commit's
#: co-resident grid for blocks of b threads is at most min(32, 2048 / b)
#: blocks an SM.
SM_BLOCKS, SM_THREADS, H100_SMS = 32, 2048, 132


def wave_commit_cases(seed=43):
    """wave_commit's edge cases, made with numpy from ``seed``: [(label,
    dict)] with the wrapper's arguments (tables and prio as uint32; None
    where a mask or table is not passed).  K = 1, 33 and 1,024; rows of
    2,048, 16,384 and 32,768 ops (T = 1 and 2: lanes over several blocks);
    T above any co-resident grid (8,192 lanes of 4; 136 lanes of 2,048 in
    16 chunks each); every op on one cell; masked keys (-1, N and past)
    and groups (G and past); dual with check_r, check_w2 and extra, and
    without the optional masks; bump on and off; a wave whose claim tag
    has its top bit clear (HIGH_WAVE).  Lanes take three roles in turn
    (from ``shift``): quiet (prio 0, no check_w2, check_r or extra: it
    commits, so its writers bump), late (quiet but for extra on its last
    op, so only the last block of a wide lane sees the conflict) and
    random.  Out-of-range groups carry no
    check_w2: the oracle's take_along_axis fill reads 0xFFFFFFFF there,
    which check_w2 counts as a claimant, where the port reads NO_PRIO (as
    claim_probe pins); the engine makes no such group."""
    rng = np.random.default_rng(seed)

    def case(label, T, K, fine, dual, bump, N=1 << 14, G=2, wave=9,
             optional=True, one_cell=False, masked=False, shift=0):
        keys = rng.integers(0, N, (T, K))
        hot = rng.integers(0, N, 8)
        keys = np.where(rng.random((T, K)) < 0.3,
                        hot[rng.integers(0, 8, (T, K))], keys)
        keys[rng.random((T, K)) < 0.05] = -1
        groups = rng.integers(0, G, (T, K))
        if K > 1024:        # the sharded owner's rows: a prio per op
            prio = rng.integers(0, 0xFFFF, (T, K))
        else:
            prio = np.broadcast_to(rng.permutation(0xFFFF)[:T, None],
                                   (T, K)).copy()
        m = [rng.random((T, K)) < p for p in (0.5, 0.5, 0.6, 0.4, 0.5)]
        extra = rng.random((T, K)) < 0.02
        if one_cell:
            keys[:], groups[:] = 7, 1
            m[0][:] = True
        if masked:
            pick = rng.random((T, K))
            keys = np.where(pick < 0.2, -1, keys)
            keys = np.where((pick >= 0.2) & (pick < 0.3),
                            rng.choice([N, N + 5, 2 ** 31 - 1], (T, K)),
                            keys)
            off = rng.random((T, K)) < 0.2
            groups = np.where(off, rng.choice([G, G + 3], (T, K)), groups)
            m[3] &= ~off
        role = (np.arange(T) + shift) % 3
        prio[role < 2] = 0
        for x in (m[3], m[4], extra):
            x[role < 2] = False
        extra[role == 1, K - 1] = True
        wts = rng.integers(0, 1 << 32, (N, G), dtype=np.uint64).astype(
            np.uint32)
        wts[7, 1] = wts[hot[0], 0] = 0xFFFFFFFF     # the bump wraps
        do_w, do_r, check_w, check_w2, check_r = m
        if not optional:
            check_w2 = extra = None
        return (label, dict(
            claim_w=claim_words(rng, N, G, wave, 0.15),
            claim_r=claim_words(rng, N, G, wave, 0.15) if dual else None,
            wts=wts if bump else None, keys=keys.astype(np.int32),
            groups=groups.astype(np.int32), prio=prio.astype(np.uint32),
            do_w=do_w, do_r=do_r if dual else None, check_w=check_w,
            check_w2=check_w2, check_r=check_r if dual else None,
            extra=extra, wave=wave, fine=fine, dual=dual, bump=bump))

    return [
        case("K=1", 64, 1, True, True, True),
        case("K=33", 16, 33, False, False, True),
        case("K=1024", 4, 1024, True, True, True),
        case("[1, 2048]", 1, 2048, False, True, True),
        case("[1, 2048] late", 1, 2048, True, True, True, shift=1),
        case("[2, 2048]", 2, 2048, True, False, False),
        case("[1, 16384]", 1, 16384, True, False, False),
        case("[1, 16384] late", 1, 16384, False, False, True, shift=1),
        case("[2, 16384]", 2, 16384, False, True, True),
        case("[1, 32768]", 1, 32768, True, True, True),
        case("[2, 32768]", 2, 32768, False, False, True, shift=1),
        case("T=8192 x K=4", 8192, 4, True, True, True, N=4096),
        case("T=136 x K=2048", 136, 2048, False, False, True, N=4096),
        case("one cell", 128, 64, True, True, True, one_cell=True),
        case("one cell, coarse", 128, 16, False, False, True,
             one_cell=True),
        case("one cell, [1, 4096]", 1, 4096, True, False, True,
             one_cell=True),
        case("masked keys and groups", 128, 64, True, True, True,
             masked=True),
        case("masked keys and groups, [4, 2048]", 4, 2048, False, True,
             True, masked=True),
        case("no optional masks", 128, 64, True, True, True,
             optional=False),
        case("bump off", 128, 64, False, False, False),
        case("HIGH_WAVE", 128, 16, True, True, True, wave=HIGH_WAVE),
        case("HIGH_WAVE, [1, 16384]", 1, 16384, False, False, True,
             wave=HIGH_WAVE),
    ]


def wave_commit_case_checks(check, dev):
    """wave_commit against its plain version on wave_commit_cases: the
    verdicts and every updated table."""
    from repro_torch import kernels as K
    from repro_torch.kernels.wave_commit import wave_commit_plain

    def t(x):
        if x is None:
            return None
        return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32
                                else x).to(dev, copy=True)
    commits = []
    for label, c in wave_commit_cases():
        outs = []
        for fn in (K.wave_commit, wave_commit_plain):
            tabs = [t(c[n]) for n in ("claim_w", "claim_r", "wts")]
            conflict, commit = fn(
                *tabs, *(t(c[n]) for n in (
                    "keys", "groups", "prio", "do_w", "do_r", "check_w",
                    "check_w2", "check_r", "extra")),
                c["wave"], c["fine"], c["dual"], c["bump"])
            outs.append((conflict, commit, *tabs))
        check.compare(*outs)
        commits.append(f"{label}: {int(outs[0][1].sum())}/"
                       f"{outs[0][1].numel()}")
    log("  wave_commit edge cases (lanes committed): " + "; ".join(commits))


#: validate's two-channel mask modes: the multi-version waves' (plain
#: writes and update-transaction reads on claim_w, ADDs on claim_r:
#: disjoint), independent masks that overlap, one channel alone, none.
PAIR_MODES = ("waves", "overlap", "w_only", "r_only", "none")


def validate_pair_cases(seed=47):
    """validate's two-channel edge cases, made with numpy from ``seed``:
    [(label, dict)] with the wrapper's arguments (tables and ``myprio`` as
    uint32).  Every mask mode of PAIR_MODES, fine and coarse, at waves
    whose claim tag has its top bit set (9) and clear (HIGH_WAVE), G = 2,
    and four more at G = 1 and 3: T = 8 lanes of K = 40 ops (320, not a
    multiple of the 256-thread block) on N = 997 rows, with hot keys, keys
    -1 and past the table's end, groups G and G + 2 (no conflict on the
    fine side; a negative group, which no wave makes, the JAX oracle would
    wrap), and priorities equal to a live claim's (a tie is no
    conflict)."""
    rng = np.random.default_rng(seed)
    N, T, K = 997, 8, 40
    configs = [(m, f, 2) for m in PAIR_MODES for f in (True, False)] + [
        ("waves", True, 1), ("overlap", False, 1), ("waves", False, 3),
        ("overlap", True, 3)]
    cases = []
    for ci, (mode, fine, G) in enumerate(configs * 2):
        wave = 9 if ci < len(configs) else HIGH_WAVE
        claim_w = claim_words(rng, N, G, wave, 0.3)
        claim_r = claim_words(rng, N, G, wave, 0.3)
        keys = rng.integers(0, N, (T, K))
        hot = rng.random((T, K)) < 0.2
        keys[hot] = rng.integers(0, 4, hot.sum())
        pick = rng.random((T, K))
        keys = np.where(pick < 0.05, -1, np.where(pick > 0.96, N + 3, keys))
        groups = rng.integers(0, G, (T, K))
        odd = rng.random((T, K))
        groups = np.where(odd < 0.04, G + 2, np.where(odd > 0.96, G, groups))
        prio = rng.integers(0, 0xFFFF, (T, K))
        prio[0, :4] = claim_w[keys[0, :4] % N, 0] & 0xFFFF   # ties
        kind = rng.integers(0, 3, (T, K))    # 0 read, 1 plain write, 2 ADD
        has_write = (kind > 0).any(axis=1)
        has_write[1] = False                 # a read-only lane
        kind[1] = 0
        if mode == "waves":
            check = (kind == 1) | ((kind == 0) & has_write[:, None])
            check_r = kind == 2
        else:
            check = rng.random((T, K)) < (0.0 if mode == "r_only" else 0.6)
            check_r = rng.random((T, K)) < (0.0 if mode == "w_only" else 0.6)
            if mode == "none":
                check[:], check_r[:] = False, False
        cases.append((
            f"{mode} {'fine' if fine else 'coarse'} G={G} wave={wave}",
            dict(claim_w=claim_w, claim_r=claim_r,
                 keys=keys.astype(np.int32), groups=groups.astype(np.int32),
                 myprio=prio.astype(np.uint32), check=check,
                 check_r=check_r, wave=wave, fine=fine)))
    return cases


def _pair_args(c, dev):
    """The two-channel validate's arguments for a validate_pair_cases
    case, on ``dev``."""
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(
            x.view(np.int32) if x.dtype == np.uint32 else x)).to(dev)
    return ((t(c["claim_w"]), t(c["keys"]), t(c["groups"]), t(c["myprio"]),
             t(c["check"]), c["wave"], c["fine"]),
            dict(claim_r=t(c["claim_r"]), check_r=t(c["check_r"])))


def validate_pair_case_checks(check, dev):
    """The two-channel validate against its plain version on
    validate_pair_cases; some case must flag a conflict on each
    channel alone."""
    from repro_torch import kernels as K
    from repro_torch.kernels.occ_validate import validate_plain
    only = {"w": 0, "r": 0}
    cases = validate_pair_cases()
    for label, c in cases:
        args, pair = _pair_args(c, dev)
        got = K.validate(*args, **pair)
        check.compare([got], [validate_plain(*args, **pair)])
        w = validate_plain(*args)
        r = validate_plain(pair["claim_r"], *args[1:4], pair["check_r"],
                           *args[5:])
        only["w"] += int((w & ~r).sum())
        only["r"] += int((r & ~w).sum())
    log(f"  validate two-channel edge cases: {len(cases)}, "
        f"conflicts on claim_w alone {only['w']}, on claim_r alone "
        f"{only['r']}")
    if not (only["w"] and only["r"]):
        raise AssertionError("validate: the pair cases must conflict on "
                             "each channel alone")


#: validate's install modes: the multi-version waves' masks (every write
#: installs into claim_w, plain writes into claim_r; plain writes and
#: update-transaction reads checked on claim_w, ADDs on claim_r),
#: independent masks (an op with both, one or neither install and check),
#: installs without checks, checks without installs, and nothing.
INSTALL_MODES = ("waves", "overlap", "install_only", "check_only", "none")
#: The install cases' wave of more ops than an H100 keeps co-resident
#: threads (H100_SMS x SM_THREADS = 270,336): lanes x slots.
INSTALL_BIG = (2048, 160)


def validate_install_cases(seed=59):
    """validate's install-and-check edge cases (the multi-version wave's
    one launch), made with numpy from ``seed``: [(label, dict)] with the
    wrapper's arguments (pre-install tables as uint32, the lane priority
    ``prio`` int32[T]).  Every mode of INSTALL_MODES, fine and coarse, at
    waves whose claim tag has its top bit set (9) and clear (HIGH_WAVE),
    G = 2, and four more at G = 1 and 3: T = 8 lanes of K = 40 ops (320,
    off the 256-thread block) on N = 997 rows, a fifth of the ops on four
    hot rows (duplicate cells in both tables), keys -1 and past the
    table's end, groups G and G + 2, a lane whose priority equals a live
    claim's (a tie is no conflict) and a read-only lane; and one
    MV-OCC-masked wave of INSTALL_BIG ops on 2**16 rows: more ops than
    one a co-resident thread, so the kernel's threads stride."""
    rng = np.random.default_rng(seed)
    configs = [(m, f, 2) for m in INSTALL_MODES for f in (True, False)] + [
        ("waves", True, 1), ("overlap", False, 1), ("waves", False, 3),
        ("overlap", True, 3)]
    shapes = [(997, 8, 40)] * (2 * len(configs))
    waves = [9] * len(configs) + [HIGH_WAVE] * len(configs)
    configs = configs * 2 + [("waves", True, 2)]
    shapes.append((1 << 16, *INSTALL_BIG))
    waves.append(9)
    cases = []
    for (mode, fine, G), (N, T, K), wave in zip(configs, shapes, waves):
        claim_w = claim_words(rng, N, G, wave, 0.3)
        claim_r = claim_words(rng, N, G, wave, 0.3)
        keys = rng.integers(0, N, (T, K))
        hot = rng.random((T, K)) < 0.2
        keys[hot] = rng.integers(0, 4, hot.sum())
        pick = rng.random((T, K))
        keys = np.where(pick < 0.05, -1, np.where(pick > 0.96, N + 3, keys))
        groups = rng.integers(0, G, (T, K))
        odd = rng.random((T, K))
        groups = np.where(odd < 0.04, G + 2, np.where(odd > 0.96, G, groups))
        prio = rng.permutation(1 << 16)[:T]
        prio[0] = claim_w[keys[0, 0] % N, 0] & 0xFFFF   # a tie
        kind = rng.integers(0, 3, (T, K))    # 0 read, 1 plain write, 2 ADD
        kind[1] = 0                          # a read-only lane
        has_write = (kind > 0).any(axis=1)
        if mode == "waves":
            install_w, install_r = kind > 0, kind == 1
            check = (kind == 1) | ((kind == 0) & has_write[:, None])
            check_r = kind == 2
        else:
            install_w, install_r, check, check_r = (
                rng.random((T, K)) < 0.5 for _ in range(4))
            if mode in ("check_only", "none"):
                install_w[:], install_r[:] = False, False
            if mode in ("install_only", "none"):
                check[:], check_r[:] = False, False
        cases.append((
            f"{mode} {'fine' if fine else 'coarse'} G={G} wave={wave} "
            f"T={T} K={K}",
            dict(claim_w=claim_w, claim_r=claim_r,
                 keys=keys.astype(np.int32), groups=groups.astype(np.int32),
                 prio=prio.astype(np.int32), install_w=install_w,
                 install_r=install_r, check=check, check_r=check_r,
                 wave=wave, fine=fine)))
    return cases


def _install_args(c, dev):
    """validate's install-and-check arguments for a
    validate_install_cases case, on ``dev``, the tables fresh copies."""
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(
            x.view(np.int32) if x.dtype == np.uint32 else x)).to(dev).clone()
    return ((t(c["claim_w"]), t(c["keys"]), t(c["groups"]), t(c["prio"]),
             t(c["check"]), c["wave"], c["fine"]),
            dict(claim_r=t(c["claim_r"]), check_r=t(c["check_r"]),
                 install_w=t(c["install_w"]), install_r=t(c["install_r"])))


def validate_install_case_checks(check, dev):
    """validate with installs against its plain version on
    validate_install_cases, verdicts and both installed tables; some
    case must flag a conflict on each channel alone."""
    from repro_torch import kernels as K
    from repro_torch.kernels.occ_validate import validate_plain
    only = {"w": 0, "r": 0}
    cases = validate_install_cases()
    for label, c in cases:
        (cw, *rest), kw = _install_args(c, dev)
        got = K.validate(cw, *rest, **kw)
        (pcw, *prest), pkw = _install_args(c, dev)
        want = validate_plain(pcw, *prest, **pkw)
        check.compare([got, cw, kw["claim_r"]],
                      [want, pcw, pkw["claim_r"]])
        myp = prest[2][:, None].expand(prest[0].shape)
        w = validate_plain(pcw, prest[0], prest[1], myp, prest[3],
                           *prest[4:])
        r = validate_plain(pkw["claim_r"], prest[0], prest[1], myp,
                           pkw["check_r"], *prest[4:])
        only["w"] += int((w & ~r).sum())
        only["r"] += int((r & ~w).sum())
    log(f"  validate install-and-check edge cases: {len(cases)} (the "
        f"largest {max(c['keys'].size for _, c in cases)} ops), conflicts "
        f"on claim_w alone {only['w']}, on claim_r alone {only['r']}")
    if not (only["w"] and only["r"]):
        raise AssertionError("validate: the install cases must conflict on "
                             "each channel alone")


def mv_install_cases(seed=61):
    """mv_install's edge cases, made with numpy from ``seed``: [(label,
    dict)] with the wrapper's arguments (``begin`` uint32[N, D, G], ``head``
    int32[N], keys, groups, ``do``, ``ts``).  D = 4 and 1, G = 1 to 3,
    T = 8 lanes of K = 40 ops on N = 64 records (duplicate writers of one
    record in one group and in different groups), keys -1 and past the
    table's end, groups G and G + 2, heads at D - 1 (the ring wraps), D,
    D + 3 and -1 (outside [0, D): a zero row carried forward), masks
    empty, full and half; every op on one record; stamps below and above
    2**31, every begin of the ring below the stamp or empty; and one
    wave of INSTALL_BIG ops on 2**16 records: more ops
    than one a co-resident thread, so the kernel keeps the later ops' new
    slots in its scratch vector."""
    rng = np.random.default_rng(seed)
    configs = [(D, G, mode) for D in (4, 1) for G in (1, 2, 3)
               for mode in ("half", "full", "none", "one_record")]
    configs.append((4, 2, "half"))
    shapes = [(64, 8, 40)] * (len(configs) - 1) + [(1 << 16, *INSTALL_BIG)]
    cases = []
    for ci, ((D, G, mode), (N, T, K)) in enumerate(zip(configs, shapes)):
        ts = 0x80000005 if ci % 2 else 1000
        begin = rng.integers(0, ts, (N, D, G)).astype(np.uint32)
        begin[rng.random((N, D, G)) < 0.3] = 0xFFFFFFFF   # empty slots
        head = rng.integers(0, D, N)
        odd = rng.integers(0, N, 4)
        head[odd] = [D - 1, D, D + 3, -1]
        keys = rng.integers(0, N, (T, K))
        sel = rng.random((T, K)) < 0.3
        keys[sel] = odd[rng.integers(0, 4, sel.sum())]
        pick = rng.random((T, K))
        keys = np.where(pick < 0.05, -1, np.where(pick > 0.96, N + 2, keys))
        groups = rng.integers(0, G, (T, K))
        g_odd = rng.random((T, K))
        groups = np.where(g_odd < 0.04, G + 2,
                          np.where(g_odd > 0.96, G, groups))
        do = rng.random((T, K)) < 0.5
        if mode == "full":
            do[:] = True
        elif mode == "none":
            do[:] = False
        elif mode == "one_record":
            keys[:] = odd[0]
            do[:] = True
        cases.append((
            f"{mode} D={D} G={G} T={T} K={K} ts={ts:#x}",
            dict(begin=begin, head=head.astype(np.int32),
                 keys=keys.astype(np.int32), groups=groups.astype(np.int32),
                 do=do, ts=ts)))
    return cases


def mv_install_case_checks(check, dev):
    """mv_install against its plain version on mv_install_cases, ring and
    heads; the largest case must exceed the kernel's one-op-a-thread
    capacity on the card."""
    import importlib
    from repro_torch import kernels as K
    from repro_torch.kernels import build
    mod = importlib.import_module("repro_torch.kernels.mv_install")
    cases = mv_install_cases()

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(
            x.view(np.int32) if x.dtype == np.uint32 else x)).to(dev).clone()
    for label, c in cases:
        args = [t(c[n]) for n in ("keys", "groups", "do")]
        a = (t(c["begin"]), t(c["head"]))
        b = (t(c["begin"]), t(c["head"]))
        K.mv_install(*a, *args, c["ts"])
        mod.mv_install_plain(*b, *args, c["ts"])
        check.compare(list(a), list(b))
    cap = None
    if dev.type == "cuda":
        cap = mod.capacity(build.load("mv_install", mod._SIG), dev)
        if not max(c["keys"].size for _, c in cases) > cap:
            raise AssertionError(f"mv_install: no case exceeds the "
                                 f"kernel's capacity of {cap} ops")
    log(f"  mv_install edge cases: {len(cases)} (the largest "
        f"{max(c['keys'].size for _, c in cases)} ops; one launch takes "
        f"{cap} ops without scratch)")


#: The install masks of the ts and claim_probe cases.
CASE_MASKS = ("half", "full", "none")


def _hot_keys(rng, N, T, K, past=3):
    """[T, K] keys on N rows, a fifth on four hot rows (duplicate cells),
    keys -1 and N + ``past``."""
    keys = rng.integers(0, N, (T, K))
    hot = rng.random((T, K)) < 0.2
    keys[hot] = rng.integers(0, 4, hot.sum())
    pick = rng.random((T, K))
    return np.where(pick < 0.05, -1, np.where(pick > 0.96, N + past, keys))


def _odd_groups(rng, G, T, K):
    """[T, K] groups in [0, G), with G and G + 2 among them."""
    groups = rng.integers(0, G, (T, K))
    odd = rng.random((T, K))
    return np.where(odd < 0.04, G + 2, np.where(odd > 0.96, G, groups))


def _case_masks(rng, mode, T, K, n):
    """``n`` bool[T, K] masks: independent halves (overlapping), all set
    or none set."""
    if mode == "full":
        return [np.ones((T, K), bool) for _ in range(n)]
    if mode == "none":
        return [np.zeros((T, K), bool) for _ in range(n)]
    return [rng.random((T, K)) < 0.5 for _ in range(n)]


def ts_install_cases(seed=67):
    """ts_install_max's three-install edge cases, made with numpy from
    ``seed``: [(label, dict)] with the wrapper's arguments: wts and rts
    uint32[N, G], keys, groups, mask, ext, ext_whole_row, commit_ts
    int64[T] and n_chain float32[T, K].
    Every mask mode of CASE_MASKS, fine (ext installs one cell) and
    coarse (ext raises the whole row), G = 2; three more at G = 1 and 3:
    T = 8 lanes of K = 40 ops (320, off the 256-thread block) on N = 997
    rows, a fifth of the ops on four hot rows (duplicate cells, cells
    both masks install into), keys -1 and past the table's end, groups G
    and G + 2, table words on both sides of 2**31, commit_ts up to
    2**32 - 1 with chains of 0 to 5 writers (stamps on both sides of
    2**31 and stamps that wrap past 2**32); and one wave of INSTALL_BIG
    ops on 2**16 rows, more than one a co-resident thread."""
    rng = np.random.default_rng(seed)
    configs = [(m, coarse, 2) for m in CASE_MASKS
               for coarse in (False, True)]
    configs += [("half", True, 1), ("half", False, 1), ("full", True, 3),
                ("half", False, 2)]
    shapes = [(997, 8, 40)] * (len(configs) - 1) + [(1 << 16, *INSTALL_BIG)]
    cases = []
    for (mode, coarse, G), (N, T, K) in zip(configs, shapes):
        def table():
            return rng.integers(0, 1 << 32, (N, G), dtype=np.uint64).astype(
                np.uint32)
        keys = _hot_keys(rng, N, T, K)
        groups = _odd_groups(rng, G, T, K)
        mask, ext = _case_masks(rng, mode, T, K, 2)
        commit_ts = rng.integers(0, 1 << 32, T, dtype=np.int64)
        commit_ts[0] = (1 << 32) - 1
        cases.append((
            f"{mode} {'coarse' if coarse else 'fine'} G={G} T={T} K={K}",
            dict(wts=table(), rts=table(), keys=keys.astype(np.int32),
                 groups=groups.astype(np.int32), mask=mask, ext=ext,
                 ext_whole_row=coarse, commit_ts=commit_ts,
                 n_chain=rng.integers(0, 6, (T, K)).astype(np.float32))))
    return cases


def _case_tensors(c, dev):
    """A case dict's arrays on ``dev`` (uint32 as int32 bit patterns,
    tables fresh copies); other values as they are."""
    def t(x):
        if not isinstance(x, np.ndarray):
            return x
        return torch.from_numpy(np.ascontiguousarray(
            x.view(np.int32) if x.dtype == np.uint32 else x)).to(dev).clone()
    return {k: t(v) for k, v in c.items()}


def ts_install_case_checks(check, dev):
    """ts_install_max's three-install form against
    ts_install_tictoc_plain (the three plain installs in the JAX order)
    on ts_install_cases, both tables compared."""
    from repro_torch import kernels as K
    from repro_torch.kernels.ts_install import ts_install_tictoc_plain
    cases = ts_install_cases()
    for label, c in cases:
        a, b = _case_tensors(c, dev), _case_tensors(c, dev)
        kw = ("rts", "ext", "ext_whole_row", "commit_ts", "n_chain")
        K.ts_install_max(a["wts"], a["keys"], a["groups"], None, a["mask"],
                         **{k: a[k] for k in kw})
        ts_install_tictoc_plain(b["wts"], b["keys"], b["groups"], b["mask"],
                                *(b[k] for k in kw))
        check.compare([a["wts"], a["rts"]], [b["wts"], b["rts"]])
    log(f"  ts_install_max edge cases: {len(cases)} (the largest "
        f"{max(c['keys'].size for _, c in cases)} ops)")


def claim_probe_cases(seed=71):
    """claim_probe's edge cases on one and two tables, made with numpy
    from ``seed``: [(label, dict)] with the wrapper's arguments:
    pre-install tables claim_w and claim_r uint32[N, G] (claim_r None
    with one table), keys, groups, the per-op priority prio int32[T, K],
    mask, mask_r (None with one table), wave, fine.  One and two tables x
    CASE_MASKS x fine and coarse, G = 2, at waves whose claim tag has its
    top bit set (9) and clear (HIGH_WAVE), and four more at G = 1 and 3:
    T = 8 lanes of K = 40 ops on N = 997 rows, a fifth of the ops on four
    hot rows (duplicate cells in both tables), keys -1 and past the end,
    groups G and G + 2, stale, empty and live words of the wave (never a
    newer one), a lane whose priority equals a live claim's; and one
    two-table wave of INSTALL_BIG ops on 2**16 rows, more ops than one a
    co-resident thread, so the kernel's threads stride."""
    rng = np.random.default_rng(seed)
    configs = [(two, m, fine, 2) for two in (False, True)
               for m in CASE_MASKS for fine in (True, False)]
    configs += [(True, "half", True, 1), (False, "half", False, 1),
                (True, "half", False, 3), (True, "full", True, 3)]
    waves = [9] * len(configs) + [HIGH_WAVE] * len(configs) + [9]
    configs = configs * 2 + [(True, "half", True, 2)]
    shapes = [(997, 8, 40)] * (len(configs) - 1) + [(1 << 16, *INSTALL_BIG)]
    cases = []
    for (two, mode, fine, G), (N, T, K), wave in zip(configs, shapes,
                                                     waves):
        claim_w = claim_words(rng, N, G, wave, 0.3)
        claim_r = claim_words(rng, N, G, wave, 0.3)
        keys = _hot_keys(rng, N, T, K)
        groups = _odd_groups(rng, G, T, K)
        lane = rng.permutation(1 << 16)[:T]
        lane[0] = claim_w[keys[0, 0] % N, 0] & 0xFFFF   # a tie
        prio = np.broadcast_to(lane[:, None], (T, K)).astype(np.int32)
        mask, mask_r = _case_masks(rng, mode, T, K, 2)
        cases.append((
            f"{'two tables' if two else 'one table'} {mode} "
            f"{'fine' if fine else 'coarse'} G={G} wave={wave} T={T} K={K}",
            dict(claim_w=claim_w, claim_r=claim_r if two else None,
                 keys=keys.astype(np.int32), groups=groups.astype(np.int32),
                 prio=prio, mask=mask, mask_r=mask_r if two else None,
                 wave=wave, fine=fine)))
    return cases


def claim_probe_case_checks(check, dev):
    """claim_probe on one and two tables against claim_probe_plain once
    per table (the JAX order) on claim_probe_cases, answers and installed
    tables; on the card the largest case must exceed the threads its SMs
    can hold, so the cooperative grid strides."""
    from repro_torch import kernels as K
    from repro_torch.kernels.claim_probe import claim_probe_plain
    cases = claim_probe_cases()
    for label, c in cases:
        a, b = _case_tensors(c, dev), _case_tensors(c, dev)
        args = [a[k] for k in ("keys", "groups", "prio")]
        got = K.claim_probe(a["claim_w"], *args, c["wave"], a["mask"],
                            c["fine"], claim_r=a["claim_r"],
                            mask_r=a["mask_r"])
        want = [claim_probe_plain(b["claim_w"], *args, c["wave"], b["mask"],
                                  c["fine"])]
        if c["claim_r"] is None:
            got = [got]
        else:
            want.append(claim_probe_plain(b["claim_r"], *args, c["wave"],
                                          b["mask_r"], c["fine"]))
        check.compare([*got, a["claim_w"], a["claim_r"]],
                      [*want, b["claim_w"], b["claim_r"]])
    cap = None
    if dev.type == "cuda":
        # The co-resident grid holds at most the SMs' thread slots.
        props = torch.cuda.get_device_properties(dev)
        cap = props.multi_processor_count * getattr(
            props, "max_threads_per_multi_processor", SM_THREADS)
        if not max(c["keys"].size for _, c in cases) > cap:
            raise AssertionError(f"claim_probe: no case exceeds the "
                                 f"card's {cap} resident threads")
    log(f"  claim_probe edge cases: {len(cases)} (the largest "
        f"{max(c['keys'].size for _, c in cases)} ops; the card holds at "
        f"most {cap} resident threads)")


#: The TicToc observe cases' lane widths: K off the 32-thread warp, one op,
#: K wider than the kernel's 256-thread block (its threads stride) and
#: several strides.
OBSERVE_WIDTHS = (40, 1, 300, 1030)


def ts_gather_cases(seed=73):
    """ts_gather's TicToc-form edge cases, made with numpy from ``seed``:
    [(label, dict)] with the wrapper's arguments: wts and rts uint32[N,
    G], keys, groups, rd and wr bool[T, K], extent int32[T, K], fine.
    Fine and coarse x the lane widths of OBSERVE_WIDTHS at G = 2, and at G =
    1 and 3 with K = 40 and 300; T = 6 lanes on N = 997 rows: a fifth of the
    ops on four hot rows, whose rts words are 0xFFFFFFFF in row 0 and in
    some groups of the others (a write's rts + 1 wraps to 0), table words on
    both sides of 2**31, keys -1 and past the end, groups G and G + 2; the
    wave's disjoint masks (an op reads, writes or neither) in most lanes,
    overlapping ones (an op both) in lane 1, none in lane 2 (commit_ts 0);
    extents 1, 0 and -2 (point ops) and 2 to 9 (scans)."""
    rng = np.random.default_rng(seed)
    N, T = 997, 6
    configs = [(fine, 2, K) for fine in (True, False)
               for K in OBSERVE_WIDTHS]
    configs += [(fine, G, K) for fine in (True, False) for G in (1, 3)
                for K in OBSERVE_WIDTHS[::2]]
    cases = []
    for fine, G, K in configs:
        def table():
            return rng.integers(0, 1 << 32, (N, G),
                                dtype=np.uint64).astype(np.uint32)
        wts, rts = table(), table()
        rts[0] = 0xFFFFFFFF
        hot = rts[1:4]
        hot[rng.random(hot.shape) < 0.5] = 0xFFFFFFFF
        kind = rng.integers(0, 3, (T, K))  # 0 read, 1 write, 2 nop
        rd, wr = kind == 0, kind == 1
        rd[1], wr[1] = rng.random(K) < 0.6, rng.random(K) < 0.6
        rd[2], wr[2] = False, False
        extent = np.where(rng.random((T, K)) < 0.7, 1,
                          rng.integers(2, 10, (T, K)))
        extent[0, :2] = (0, -2)[:K]
        keys = _hot_keys(rng, N, T, K)
        keys[3, 0], keys[4, -1] = -1, N + 3
        groups = _odd_groups(rng, G, T, K)
        groups[5, 0] = G + 2
        cases.append((
            f"{'fine' if fine else 'coarse'} G={G} T={T} K={K}",
            dict(wts=wts, rts=rts, keys=keys.astype(np.int32),
                 groups=groups.astype(np.int32), rd=rd, wr=wr,
                 extent=extent.astype(np.int32), fine=fine)))
    return cases


def ts_gather_case_checks(check, dev):
    """ts_gather's TicToc form against tictoc_observe_plain (the two plain
    gathers and TicToc's arithmetic) on ts_gather_cases, commit_ts and
    ext_need; some case must wrap a write's rts + 1 and need an
    extension."""
    from repro_torch import kernels as K
    from repro_torch.kernels.ts_gather import tictoc_observe_plain
    cases = ts_gather_cases()
    need = 0
    for label, c in cases:
        a = _case_tensors(c, dev)
        args = [a[k] for k in ("keys", "groups")]
        kw = {k: a[k] for k in ("rd", "wr", "extent")}
        got = K.ts_gather(a["wts"], *args, c["fine"], rts=a["rts"], **kw)
        want = tictoc_observe_plain(a["wts"], a["rts"], *args, c["fine"],
                                    **kw)
        check.compare(got, want)
        need += int(want[1].sum())
    log(f"  ts_gather TicToc edge cases: {len(cases)} (K up to "
        f"{max(OBSERVE_WIDTHS)}), {need} reads need an extension")
    if not need:
        raise AssertionError("ts_gather: no case needs an extension")


def ring_fold_cases(seed=79):
    """The multi-version waves' folded ring reads, made with numpy from
    ``seed``: [(label, dict)] with validate's install-and-check arguments
    as validate_install_cases makes them (claim_w, claim_r uint32[N, G],
    keys, groups, the lane priority prio int32[T], install_w, install_r,
    check, check_r, wave, fine) plus the version ring ``begin`` uint32[N,
    D, G] and the snapshot ``snap_ts``, and the read masks ``is_r`` and
    ``is_rp`` (a subset of is_r); claim_probe's verdict form takes the
    same tables and ops as [D, M] rows of 40 ops (mask = install_w, mask_r
    = install_r, the lane priority per op, is_r, is_rp).  Fine and coarse x D = 4 with G = 1 to 3 and D = 1
    with G = 2, T = 8 lanes of K = 40 ops on N = 997 rows, at claim-tag
    halves and ring
    stamps that alternate (stamps from 1 and from 0x7FFFFFF8 + 1: both
    sides of 2**31), the waves' masks and overlapping ones in turn: ring
    slots empty (MV_EMPTY) at random, a record whose every slot is empty,
    one whose every stamp postdates the snapshot (reclaimed), hot rows,
    keys -1 and past the end, groups G and G + 2, a tie; and one wave of
    INSTALL_BIG ops on 2**16 rows, more than one a co-resident thread."""
    rng = np.random.default_rng(seed)
    reads = np.random.default_rng(seed + 1)
    configs = [(fine, D, G) for fine in (True, False)
               for D, G in ((4, 1), (4, 2), (4, 3), (1, 2))] + [(True, 4, 2)]
    shapes = [(997, 8, 40)] * (len(configs) - 1) + [(1 << 16,
                                                      *INSTALL_BIG)]
    cases = []
    for ci, ((fine, D, G), (N, T, K)) in enumerate(zip(configs, shapes)):
        wave = HIGH_WAVE if ci % 2 else 9
        base = HIGH_TS if ci % 4 >= 2 else 0
        snap = base + 10
        begin = rng.integers(base + 1, base + 21, (N, D, G)).astype(
            np.uint32)
        begin[rng.random((N, D, G)) < 0.3] = 0xFFFFFFFF
        begin[1] = base + 11 + np.arange(D * G).reshape(D, G)  # reclaimed
        begin[2] = 0xFFFFFFFF                                  # all empty
        keys = _hot_keys(rng, N, T, K)
        groups = _odd_groups(rng, G, T, K)
        claim_w = claim_words(rng, N, G, wave, 0.3)
        claim_r = claim_words(rng, N, G, wave, 0.3)
        prio = rng.permutation(1 << 16)[:T]
        prio[0] = claim_w[keys[0, 0] % N, 0] & 0xFFFF       # a tie
        if ci % 3 == 2:
            install_w, install_r, check, check_r = (
                rng.random((T, K)) < 0.5 for _ in range(4))
            is_r = reads.random((T, K)) < 0.5
            mode = "overlap"
        else:
            kind = rng.integers(0, 3, (T, K))  # 0 read, 1 write, 2 ADD
            has_write = (kind > 0).any(axis=1)
            install_w, install_r = kind > 0, kind == 1
            check = (kind == 1) | ((kind == 0) & has_write[:, None])
            check_r = kind == 2
            is_r = kind == 0
            mode = "waves"
        cases.append((
            f"{mode} {'fine' if fine else 'coarse'} D={D} G={G} "
            f"wave={wave} ts={snap:#x} T={T} K={K}",
            dict(claim_w=claim_w, claim_r=claim_r,
                 keys=keys.astype(np.int32), groups=groups.astype(np.int32),
                 prio=prio.astype(np.int32), install_w=install_w,
                 install_r=install_r, check=check, check_r=check_r,
                 wave=wave, fine=fine, begin=begin, snap_ts=snap,
                 is_r=is_r, is_rp=is_r & (reads.random((T, K)) < 0.7))))
    return cases


def ring_fold_case_checks(checks, dev):
    """validate's ring form and claim_probe's verdict form (two tables
    and the ring) against their plain versions (the installs and check or
    probes, mv_gather_plain, and for claim_probe the owner's verdict bits
    and verdict_pack_plain) on ring_fold_cases: validate's verdicts and
    ok, claim_probe's verdict words, both installed tables; some case must
    see a reclaimed snapshot and some a visible one."""
    from repro_torch import kernels as K
    from repro_torch.kernels.claim_probe import claim_probe_verdict_plain
    from repro_torch.kernels.occ_validate import validate_plain
    cases = ring_fold_cases()
    seen = {True: 0, False: 0}
    for label, c in cases:
        outs = []
        for fn in (K.validate, validate_plain):
            a = _case_tensors(c, dev)
            res = fn(a["claim_w"], a["keys"], a["groups"], a["prio"],
                     a["check"], c["wave"], c["fine"], claim_r=a["claim_r"],
                     check_r=a["check_r"], install_w=a["install_w"],
                     install_r=a["install_r"], begin=a["begin"],
                     snap_ts=c["snap_ts"])
            outs.append([*res, a["claim_w"], a["claim_r"]])
        checks["validate"].compare(*outs)
        for v in (True, False):
            seen[v] += int((outs[1][1] == v).sum())
        a, b = _case_tensors(c, dev), _case_tensors(c, dev)
        args = [a["keys"], a["groups"],
                a["prio"][:, None].expand(a["keys"].shape).contiguous()]
        got = K.claim_probe(a["claim_w"], *args, c["wave"], a["install_w"],
                            c["fine"], claim_r=a["claim_r"],
                            mask_r=a["install_r"], begin=a["begin"],
                            snap_ts=c["snap_ts"], is_r=a["is_r"],
                            is_rp=a["is_rp"])
        want = claim_probe_verdict_plain(
            b["claim_w"], *args, c["wave"], b["install_w"], c["fine"],
            b["claim_r"], b["install_r"], b["begin"], c["snap_ts"],
            b["is_r"], b["is_rp"])
        checks["claim_probe"].compare([got, a["claim_w"], a["claim_r"]],
                                      [want, b["claim_w"], b["claim_r"]])
    log(f"  ring-fold edge cases (validate and claim_probe): {len(cases)} "
        f"(the largest {max(c['keys'].size for _, c in cases)} ops), "
        f"{seen[True]} ops see a version, {seen[False]} none")
    if not (seen[True] and seen[False]):
        raise AssertionError("ring folds: the cases must see visible and "
                             "reclaimed snapshots")


#: The bump fold's lane roles, in turn over a case's lanes: a point
#: conflict only, a phantom only, neither (the lane commits and its writes
#: bump) and both.
BUMP_ROLES = ("point", "phantom", "neither", "both")
#: bump_fold_cases' shapes (K, T, G, fine, B, ext_cap, N, writes): one op a
#: lane (256 lanes a block, a partial second block), 16 and 64 (K off and
#: on the warp), 160 (one lane a block) in a wave past an H100's resident
#: threads, 1,024 in 32 lanes (one block a lane, four strides) and 1,030
#: (a ragged last stride); G = 1 to 3, fine and coarse, B = 8 and 1;
#: ``writes`` False masks every write.
BUMP_SHAPES = (
    (1, 300, 2, False, 8, 8, 997, True),
    (16, 40, 3, True, 8, 16, 997, True),
    (64, 12, 1, False, 1, 33, 997, True),
    (64, 16, 2, True, 8, 9, 997, False),
    (1024, 32, 2, False, 8, 24, 4001, True),
    (1030, 3, 2, True, 8, 40, 4001, True),
    (160, 2048, 2, False, 8, 8, 1 << 16, True))


def bump_fold_cases(seed=89):
    """iterate_validate's bump form (a scan wave's phantom pass and its
    version bumps in one launch), made with numpy from ``seed``: [(label,
    dict)] with the wrapper's arguments (``table``, ``myprio`` and ``wts``
    as uint32; ``myprio`` the lane priority broadcast to [T, K], as the
    engine passes it) and each lane's role.  Every shape of BUMP_SHAPES
    at waves whose claim tag has its top bit set (9) and clear
    (HIGH_WAVE), the largest at 9 only.  Lanes take the roles of
    BUMP_ROLES in turn: point lanes get a point conflict on one op and
    priority 0 (no claim is stronger), phantom lanes a checked scan on op
    0 over a planted stronger claim and priority 0xFFFE, neither lanes
    priority 0 and no point conflict.  Keys -1 and past the end, extents 0
    and -5, groups G and G + 2, a fifth of the ops on four hot rows
    (duplicate write cells across lanes) whose wts words sit at
    0xFFFFFFFF - 0..2 (their bumps wrap)."""
    rng = np.random.default_rng(seed)
    cases = []
    for K, T, G, fine, B, ext_cap, N, writes in BUMP_SHAPES:
        for wave in ((9,) if T * K > 100_000 else (9, HIGH_WAVE)):
            table = claim_words(rng, N, G, wave, 0.1)
            keys = _hot_keys(rng, N, T, K)
            groups = _odd_groups(rng, G, T, K)
            ext = np.where(rng.random((T, K)) < 0.4,
                           rng.integers(2, ext_cap + 1, (T, K)), 1)
            ext[rng.random((T, K)) < 0.02] = 0
            ext[rng.random((T, K)) < 0.02] = -5
            do = (rng.random((T, K)) < 0.4) & writes
            check = ~do & (rng.random((T, K)) < 0.9)
            point = np.zeros((T, K), bool)
            roles = np.array([BUMP_ROLES[t % 4] for t in range(T)])
            prio = np.where(np.isin(roles, ("phantom", "both")), 0xFFFE, 0)
            wts = rng.integers(0, 1 << 32, (N, G), dtype=np.uint64)
            wts[:4] = 0xFFFFFFFF - rng.integers(0, 3, (4, G))
            for t in range(T):
                if roles[t] in ("point", "both"):
                    point[t, rng.integers(0, K)] = True
                if roles[t] in ("phantom", "both"):
                    k0 = int(rng.integers(4, N - ext_cap))
                    g0 = int(rng.integers(0, G))
                    keys[t, 0], groups[t, 0] = k0, g0
                    ext[t, 0], check[t, 0], do[t, 0] = ext_cap, True, False
                    table[k0, g0] = _live_word(wave, 0x0100)
            cases.append((
                f"K={K} T={T} G={G} {'fine' if fine else 'coarse'} B={B} "
                f"ext_cap={ext_cap} wave={wave}"
                + ("" if writes else " every write masked"),
                dict(table=table, keys=keys.astype(np.int32),
                     extents=ext.astype(np.int32),
                     groups=groups.astype(np.int32),
                     myprio=np.broadcast_to(prio[:, None], (T, K)).astype(
                         np.uint32),
                     check=check, wave=wave, fine=fine, bucket_size=B,
                     ext_cap=ext_cap, point=point, do=do,
                     wts=wts.astype(np.uint32), roles=tuple(roles))))
    return cases


def bump_fold_outcomes(point, phantom, roles) -> dict:
    """{role: lanes} of what a bump case's lanes did: a point conflict
    only, a phantom only, neither, both (``phantom`` from the plain
    phantom pass)."""
    p, q = np.asarray(point).any(axis=1), np.asarray(phantom).any(axis=1)
    got = {"point": p & ~q, "phantom": ~p & q, "neither": ~p & ~q,
           "both": p & q}
    return {r: int(m.sum()) for r, m in got.items()}


def _bump_args(c):
    return [c[k] for k in ("table", "keys", "extents", "groups", "myprio",
                           "check")] + [c["wave"], c["fine"],
                                        c["bucket_size"], c["ext_cap"]]


def bump_fold_case_checks(check, dev):
    """iterate_validate's bump form against its plain version (the chain
    iterate_validate_plain | point, commit_install_plain(do & ~any)) on
    bump_fold_cases: the verdicts and the bumped wts.  The cases must
    reach every lane role, bump, and wrap a word."""
    from repro_torch import kernels as K
    from repro_torch.kernels.iterate_validate import iterate_validate_plain
    cases = bump_fold_cases()
    seen = {r: 0 for r in BUMP_ROLES}
    bumped = wrapped = 0
    for label, c in cases:
        a, b = _case_tensors(c, dev), _case_tensors(c, dev)
        got = K.iterate_validate(*_bump_args(a), point=a["point"],
                                 wts=a["wts"], do=a["do"])
        want = iterate_validate_plain(*_bump_args(b), point=b["point"],
                                      wts=b["wts"], do=b["do"])
        check.compare([got, a["wts"]], [want, b["wts"]])
        phantom = iterate_validate_plain(*_bump_args(b))
        for r, n in bump_fold_outcomes(b["point"].cpu(), phantom.cpu(),
                                       c["roles"]).items():
            seen[r] += n
        w0 = c["wts"]
        w1 = b["wts"].cpu().numpy().view(np.uint32)
        bumped += int((w1 != w0).sum())
        wrapped += int(((w1 < w0)).sum())
    log(f"  iterate_validate bump-form edge cases: {len(cases)} (the "
        f"largest {max(c['keys'].size for _, c in cases)} ops), lanes by "
        f"outcome {seen}, {bumped} wts words bumped, {wrapped} wrapped")
    if min(seen.values()) <= 0 or not (bumped and wrapped):
        raise AssertionError("iterate_validate bump form: the cases must "
                             "reach every lane role, bump and wrap")


#: validate_dual's install-form modes: AutoGran's masks (writes install,
#: point reads check), independent halves (ops that install and check),
#: installs alone, checks alone, nothing.
DUAL_MODES = ("waves", "overlap", "install_only", "check_only", "none")


def dual_install_cases(seed=97):
    """validate_dual's install form (AutoGran's write-claim install and
    its dual check in one launch), made with numpy from ``seed``:
    [(label, dict)] with the wrapper's arguments (the pre-install table as
    uint32, the lane priority ``prio`` int32[T]).  Every mode of
    DUAL_MODES at G = 2, and AutoGran's masks at G = 1 and 3 and the
    overlap at G = 3, at waves whose claim tag has its top bit set (9)
    and clear (HIGH_WAVE): T = 8 lanes of K = 40 ops (320, off the
    256-thread block) on N = 997 rows; K = 1 (300 lanes) and K = 1,030 (3
    lanes); a fifth of the ops on four hot rows (duplicate cells), keys
    -1 and past the end, groups G and G + 2, a lane whose priority ties a
    claim; and AutoGran's masks on a wave of INSTALL_BIG ops on 2**16
    rows, past an H100's resident threads, so the kernel's threads
    stride."""
    rng = np.random.default_rng(seed)
    configs = [(m, 2, (997, 8, 40)) for m in DUAL_MODES] + [
        ("waves", 1, (997, 8, 40)), ("waves", 3, (997, 8, 40)),
        ("overlap", 3, (997, 8, 40)), ("waves", 2, (997, 300, 1)),
        ("overlap", 2, (4001, 3, 1030))]
    configs = [(*c, w) for w in (9, HIGH_WAVE) for c in configs] + [
        ("waves", 2, (1 << 16, *INSTALL_BIG), 9)]
    cases = []
    for mode, G, (N, T, K), wave in configs:
        claim_w = claim_words(rng, N, G, wave, 0.3)
        keys = _hot_keys(rng, N, T, K)
        groups = _odd_groups(rng, G, T, K)
        prio = rng.permutation(1 << 16)[:T]
        prio[0] = claim_w[keys[0, 0] % N, 0] & 0xFFFF   # a tie
        write = rng.random((T, K)) < 0.4
        if mode == "waves":
            install, check = write, ~write & (rng.random((T, K)) < 0.9)
        else:
            install, check = (rng.random((T, K)) < 0.5 for _ in range(2))
            if mode in ("check_only", "none"):
                install[:] = False
            if mode in ("install_only", "none"):
                check[:] = False
        cases.append((
            f"{mode} G={G} wave={wave} T={T} K={K}",
            dict(claim_w=claim_w, keys=keys.astype(np.int32),
                 groups=groups.astype(np.int32), prio=prio.astype(np.int32),
                 check=check, wave=wave, install=install)))
    return cases


def dual_install_case_checks(check, dev):
    """validate_dual's install form against its plain version
    (claim_scatter_plain on the expanded priority, then
    validate_dual_plain) on dual_install_cases: both verdicts and the
    installed table.  Some case must see a conflict that only this
    wave's installs give, and a coarse conflict the fine side does not
    see; on the card the largest case must exceed the resident threads."""
    from repro_torch import kernels as K
    from repro_torch.kernels.occ_validate import validate_dual_plain
    cases = dual_install_cases()
    fresh = coarse_only = 0
    for label, c in cases:
        a, b = _case_tensors(c, dev), _case_tensors(c, dev)
        got = K.validate_dual(a["claim_w"], a["keys"], a["groups"],
                              a["prio"], a["check"], c["wave"],
                              install=a["install"])
        want = validate_dual_plain(b["claim_w"], b["keys"], b["groups"],
                                   b["prio"], b["check"], c["wave"],
                                   b["install"])
        check.compare([*got, a["claim_w"]], [*want, b["claim_w"]])
        p = _case_tensors(c, dev)
        before = validate_dual_plain(
            p["claim_w"], p["keys"], p["groups"],
            p["prio"][:, None].expand(p["keys"].shape), p["check"],
            c["wave"])
        fresh += int((want[1] & ~before[1]).sum())
        coarse_only += int((want[1] & ~want[0]).sum())
    cap = None
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        cap = props.multi_processor_count * getattr(
            props, "max_threads_per_multi_processor", SM_THREADS)
        if not max(c["keys"].size for _, c in cases) > cap:
            raise AssertionError(f"validate_dual: no install case exceeds "
                                 f"the card's {cap} resident threads")
    log(f"  validate_dual install-form edge cases: {len(cases)} (the "
        f"largest {max(c['keys'].size for _, c in cases)} ops; the card "
        f"holds at most {cap} resident threads), {fresh} coarse conflicts "
        f"from this wave's installs, {coarse_only} coarse-only")
    if not (fresh and coarse_only):
        raise AssertionError("validate_dual install form: the cases must "
                             "conflict on this wave's installs and on the "
                             "coarse side alone")


#: route_pack's edge cases (M, n_dest, cap, W, skew): the one-card wave
#: (4,096 ops), with scans (8,192) and TPC-C's (16,384; 32,768 with
#: scans); M off the 256-op tile, one op, none; n_dest 1, 3, 8 and
#: MAX_DESTINATIONS; cap 0, 16 (forced drops) and DistConfig's (None);
#: skewed waves that overflow a destination; W 1, 3 and MAX_CHANNELS; a
#: wave of more tiles than an H100 keeps resident blocks (several tiles a
#: block).
ROUTE_CASES = (
    (4096, 1, None, 3, False), (4096 + 37, 3, None, 3, False),
    (4096, 8, None, 3, True), (8192, 1, None, 3, False),
    (8192, 8, 16, 3, False), (300, 3, 0, 3, False), (1, 1, 16, 1, False),
    (0, 3, 16, 3, False), (1000, "max", 8, 8, False),
    (5003, 8, None, 8, True), (16384, 8, None, 3, False),
    (16384 + 5, 3, None, 3, False), (32768, 1, None, 3, True),
    (40013, 3, 16, 1, True), (300007, 8, None, 3, False),
    (20000, "max", 16, 2, False))
#: The case whose buffer holds more than 2**31 words (W 1, 2 destinations
#: of 2**30 + 8 cells, 8.6 GB): cell indices past int32.  The card only.
ROUTE_HUGE_CASE = (3000, 2, (1 << 30) + 8, 1, False)


def route_pack_cases(seed=53, huge=False):
    """route_pack's edge cases, made with numpy from ``seed``: [(label,
    dict(owner int32[M], vals int32[W, M], n_dest, cap, fills))] for
    ROUTE_CASES (and ROUTE_HUGE_CASE with ``huge``).  A tenth of the
    owners are masked (-1, n_dest, n_dest + 5); a skewed wave sends every
    live op to its last destination."""
    from repro_torch.kernels.route_pack import (MAX_CHANNELS,
                                                MAX_DESTINATIONS)
    rng = np.random.default_rng(seed)
    out = []
    for M, n_dest, cap, W, skew in ROUTE_CASES + (
            (ROUTE_HUGE_CASE,) if huge else ()):
        n_dest = MAX_DESTINATIONS if n_dest == "max" else n_dest
        cap = _dist_cap(M, 1, n_dest, False) if cap is None else cap
        W = min(W, MAX_CHANNELS)
        owner = rng.integers(0, n_dest, M)
        if skew:
            owner[:] = n_dest - 1
        owner = np.where(rng.random(M) < 0.1,
                         rng.choice([-1, n_dest, n_dest + 5], M), owner)
        vals = rng.integers(-2 ** 31, 2 ** 31, (W, M), dtype=np.int64)
        fills = tuple(int(f) for f in rng.integers(-2 ** 31, 2 ** 31, W))
        out.append((f"M={M} n_dest={n_dest} cap={cap} W={W}"
                    + (" skewed" if skew else ""),
                    dict(owner=owner.astype(np.int32),
                         vals=vals.astype(np.int32), n_dest=n_dest,
                         cap=cap, fills=fills)))
    return out


def route_pack_case_checks(check, dev):
    """route_pack against its plain version on route_pack_cases, the
    buffer of more than 2**31 words included on the card (compared with
    torch.equal: a float difference of it would not fit)."""
    from repro_torch import kernels as K
    from repro_torch.kernels.route_pack import route_pack_plain
    dropped = []
    for label, c in route_pack_cases(huge=dev.type == "cuda"):
        owner = torch.from_numpy(c["owner"]).to(dev)
        vals = torch.from_numpy(c["vals"]).to(dev)
        args = (owner, vals, c["n_dest"], c["cap"], c["fills"])
        got = K.route_pack(*args)
        want = route_pack_plain(*args)
        if got[0].numel() >= 1 << 31:
            if not torch.equal(got[0], want[0]):
                raise AssertionError(f"route_pack {label}: the buffer "
                                     "differs from the plain version's")
            got, want = got[1:], want[1:]
        check.compare(got, want)
        live = (owner >= 0) & (owner < c["n_dest"])
        dropped.append(int((live & ~got[-1]).sum()))
        del got, want
    log(f"  route_pack edge cases: {len(dropped)}, dropped ops {dropped}")
    if not (min(dropped) == 0 and max(dropped) > 0):
        raise AssertionError("route_pack cases must include drops and "
                             "drop-free waves")


# ------------------------------------------------------- apply_values
#: apply_values' timed forms: (timing name, N, T, K, C, D; D = 0 the flat
#: values): TPC-C's flat values (the kernel's main-path row), YCSB's,
#: TPC-C's version ring of D = 4 with the copy-forward (head_old, the
#: MV waves' call), and TPC-C's flat values at 512 lanes, past the
#: one-launch form (the grid form).
APPLY_TIMED = (("apply_values", TPCC_N, 128, 64, 4, 0),
               ("apply_values_ycsb", YCSB_N, 128, 16, 10, 0),
               ("apply_values_ring", TPCC_N, 128, 64, 4, MV_DEPTH),
               ("apply_values_grid", TPCC_N, 512, 64, 4, 0))
#: The input modes of apply_values_cases: hot records among random ones
#: with masked keys, keys past the table and uncommitted lanes; every op on
#: one cell; each lane's ops on four cells of its own; nothing committed;
#: signed priorities (negatives, ties, the int32 extremes) with columns
#: from -C-1 to C and ring heads from -D-1 to D (the reference counts a
#: negative index from the end once and drops one past either end).
APPLY_MODES = ("mixed", "one_cell", "lane_cells", "none", "signed")


def apply_values_inputs(N, T, K, C, D, mode, dev, seed):
    """One wave's replay inputs on ``dev`` from ``seed``: (values f32[N,
    C] or the ring [N, D, C], batch, commit bool[T], prio int32[T],
    slot_of int32[N] or None, head_old int32[N] or None), the ops made
    with numpy, the tables with a generator on ``dev``.  The ring's new
    heads are the old ones plus 1 (mod D), or in the signed mode both
    drawn from [-D-1, D].  Deltas are non-integer, so the float32 sums
    depend on their order."""
    from repro_torch.core import types as t
    rng = np.random.default_rng(seed)
    kind = rng.choice([t.NOP, t.READ, t.WRITE, t.ADD], (T, K),
                      p=[0.1, 0.3, 0.25, 0.35])
    col = rng.integers(0, C, (T, K))
    key = rng.integers(0, N, (T, K))
    commit = rng.random(T) < 0.7
    commit[0] = True
    prio = rng.permutation(T)
    if mode in ("mixed", "signed"):
        hot = rng.integers(0, N, 8)
        pick = rng.random((T, K))
        key = np.where(pick < 0.3, hot[rng.integers(0, 8, (T, K))], key)
        key = np.where(pick > 0.9, -1, key)
        key = np.where((pick > 0.88) & (pick <= 0.9), N + 3, key)
    if mode == "one_cell":
        key[:], col[:] = N // 2, C - 1
        kind = np.where(rng.random((T, K)) < 0.1, t.WRITE, t.ADD)
    elif mode == "lane_cells":
        key = rng.integers(0, N, (T, 4))[np.arange(T)[:, None],
                                         rng.integers(0, 4, (T, K))]
        col = np.zeros_like(col)
    elif mode == "none":
        commit[:] = False
    elif mode == "signed":
        col = rng.integers(-C - 1, C + 1, (T, K))
        prio = rng.integers(-(T // 4) - 1, T // 4 + 1, T)
        prio[rng.integers(0, T, 2)] = (np.iinfo(np.int32).min,
                                       np.iinfo(np.int32).max)
    vals = (rng.standard_normal((T, K)) * 3.3).astype(np.float32)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    table = torch.randn((N, D, C) if D else (N, C), generator=g,
                        device=dev) * 0.7
    fields = dict(op_key=key, op_group=np.zeros_like(key), op_col=col,
                  op_kind=kind, op_val=vals,
                  txn_type=np.zeros(T), n_ops=np.full(T, K))

    def d(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a.astype(dtype))).to(dev)
    batch = t.TxnBatch(**{k: d(v, np.float32 if k == "op_val" else np.int32)
                          for k, v in fields.items()})
    slot_of = head_old = None
    if D and mode == "signed":
        slot_of, head_old = (torch.randint(-D - 1, D + 1, (N,), generator=g,
                                           device=dev, dtype=torch.int32)
                             for _ in range(2))
    elif D:
        head_old = torch.randint(0, D, (N,), generator=g, device=dev,
                                 dtype=torch.int32)
        slot_of = (head_old + 1) % D
    return (table, batch, d(commit, np.bool_), d(prio, np.int32), slot_of,
            head_old)


def apply_values_cases(shapes=APPLY_TIMED):
    """(label, N, T, K, C, D, mode): every mode at each timed shape, plus
    one op, one lane of 1,030 ops (wider than a block), a ring of D = 1
    and 2,048 lanes of 2 ops (past the one-launch form's lanes)."""
    out = [(f"{name} {mode}", N, T, K, C, D, mode)
           for name, N, T, K, C, D in shapes for mode in APPLY_MODES]
    return out + [("one op", 17, 1, 1, 3, 0, "one_cell"),
                  ("wide lane", 5000, 3, 1030, 2, 0, "mixed"),
                  ("ring D=1", 5000, 16, 40, 3, 1, "mixed"),
                  ("ring D=1 signed", 5000, 16, 40, 3, 1, "signed"),
                  ("many lanes", 5000, 2048, 2, 3, 0, "signed")]


def _apply_bytes(table, batch, commit, prio, slot_of, head_old=None):
    """Bytes the replay must move on these inputs: per op a key, a column,
    a kind and a value, per lane a commit byte and a priority; without
    the copy-forward each written cell read and written once (the ring
    also reads each written record's slot once); with it (``head_old``)
    each written record's two heads read once and its row read and
    written once, which holds every cell the replay writes there.
    Returns (bytes, ops applied)."""
    from repro_torch.core import types as t
    from repro_torch.kernels.apply_values import _serial_ops
    T, K = batch.op_key.shape
    cell, act, _, _ = _serial_ops(table, batch, commit, prio, slot_of)
    n_bytes = T * K * 16 + T * 5
    if head_old is None:
        n_bytes += torch.unique(cell[act]).numel() * 8
    if slot_of is not None:
        N, _, C = table.shape
        key = batch.op_key
        do = (commit[:, None] & ((batch.op_kind == t.WRITE)
                                 | (batch.op_kind == t.ADD))
              & (key >= 0) & (key < N))
        per_record = 4 if head_old is None else 8 + 8 * C
        n_bytes += torch.unique(key[do]).numel() * per_record
    return n_bytes, int(act.sum())


def apply_values_checks(check, dev, shapes=APPLY_TIMED, seed=101):
    """apply_values against its plain version on every case, bit for bit
    (the updated values; the ring with the copy-forward), then the timed
    forms: kernel, plain replay and bound at each of ``shapes`` on its
    mixed input.  Returns {name: timing dict}."""
    from repro_torch import kernels as K
    from repro_torch.kernels.apply_values import apply_values_plain, route
    for i, (label, N, T, Kk, C, D, mode) in enumerate(
            apply_values_cases(shapes)):
        table, batch, commit, prio, slot_of, head_old = apply_values_inputs(
            N, T, Kk, C, D, mode, dev, seed + i)
        a, b = table.clone(), table.clone()
        K.apply_values(a, batch, commit, prio, slot_of, head_old)
        apply_values_plain(b, batch, commit, prio, slot_of, head_old)
        check.compare([a], [b])
        if not check.equal:
            raise AssertionError(f"apply_values case {label} ({route(T, Kk)}"
                                 " form) differs from the plain replay")
        if mode != "none" and torch.equal(a, table):
            raise AssertionError(f"apply_values case {label}: no cell "
                                 "changed")
    timings = {}
    for i, (name, N, T, Kk, C, D) in enumerate(shapes):
        table, batch, commit, prio, slot_of, head_old = apply_values_inputs(
            N, T, Kk, C, D, "mixed", dev, seed + 50 + i)
        n_bytes, n_act = _apply_bytes(table, batch, commit, prio, slot_of,
                                     head_old)
        timings[name] = dict(
            form=(f"ring D={D}, the copy-forward from head_old, slot_of the "
                  f"new heads" if D else "flat values")
                 + f", {route(T, Kk)} form",
            shape=f"T={T} K={Kk} N={N} C={C}" + (f" D={D}" if D else ""),
            ms=time_ms(lambda: K.apply_values(table, batch, commit, prio,
                                              slot_of, head_old), dev),
            plain_ms=time_ms(lambda: apply_values_plain(
                table, batch, commit, prio, slot_of, head_old), dev, n=3,
                warmup=1),
            library_ms=None, bound=bound_ms(n_bytes, n_act))
    return timings


def kernel_phase(dev, shapes, wave=9, dist_lanes=DIST_LANES,
                 apply_shapes=APPLY_TIMED):
    """Compare every kernel with its plain version over every flag
    combination at ``shapes``, and the sharded wave's kernels at its
    shapes for ``dist_lanes`` lanes; time them.  apply_values at
    ``apply_shapes``, its timings under the label "tpcc".  Returns
    ({name: KernelCheck}, {label: {name: timing dict}}), the sharded
    wave's kernels under the label "dist"."""
    from repro_torch import kernels as K
    from repro_torch.core.claimword import claim_word
    from repro_torch.core.claimword import inv_wave
    from repro_torch.kernels.claim_probe import claim_probe_plain
    from repro_torch.kernels.claim_scatter import claim_scatter_plain
    from repro_torch.kernels.occ_commit import commit_install_plain
    from repro_torch.kernels.occ_validate import validate_dual_plain
    from repro_torch.kernels.segment_count import segment_count_plain
    from repro_torch.kernels.ts_gather import (tictoc_observe_plain,
                                               ts_gather_plain)
    from repro_torch.kernels.ts_install import (ts_install_max_plain,
                                                ts_install_tictoc_plain)
    from repro_torch.kernels.wave_commit import probe_plain, \
        wave_commit_plain
    checks = {n: KernelCheck(n) for n in KERNEL_META}
    timings = {}
    for si, (label, (N, G, T, Kk)) in enumerate(shapes.items()):
        cw0, cr0, wts0, ts0 = make_tables(N, G, wave, dev, seed=si)
        keys, groups, prio, masks, vals = make_ops(N, G, T, Kk, dev, si)
        do_w, do_r, check_w, check_w2, check_r, extra = masks
        for fine in (True, False):
            for dual in (False, True):
                for bump in (False, True):
                    for optional in (True, False):
                        opt = (check_w2, check_r, extra) if optional else \
                            (None, check_r if dual else None, None)
                        outs = []
                        for fn in (K.wave_commit, wave_commit_plain):
                            cw, cr, wt = cw0.clone(), cr0.clone(), \
                                wts0.clone()
                            conflict, commit = fn(
                                cw, cr, wt, keys, groups, prio, do_w, do_r,
                                check_w, opt[0], opt[1], opt[2], wave, fine,
                                dual, bump)
                            outs.append((conflict, commit, cw, cr, wt))
                        checks["wave_commit"].compare(*outs)
        for G_ in (1, 2):
            for mask in (do_w, check_r):
                gr = groups if G_ == 2 else torch.zeros_like(groups)
                checks["segment_count"].compare(
                    [K.segment_count(keys, gr, G_, mask)],
                    [segment_count_plain(keys, gr, G_, mask)])
        for fine in (True, False):
            checks["ts_gather"].compare(
                [K.ts_gather(ts0, keys, groups, fine),
                 K.ts_gather(wts0, keys, groups, fine)],
                [ts_gather_plain(ts0, keys, groups, fine),
                 ts_gather_plain(wts0, keys, groups, fine)])
        # TicToc's form: reads at do_r, writes at do_w (overlapping), scan
        # extents, both table orders.
        obs = dict(rd=do_r, wr=do_w,
                   extent=scan_extents(keys, N, 9, si)[1])
        for fine in (True, False):
            for w_, r_ in ((wts0, ts0), (ts0, wts0)):
                checks["ts_gather"].compare(
                    K.ts_gather(w_, keys, groups, fine, rts=r_, **obs),
                    tictoc_observe_plain(w_, r_, keys, groups, fine, **obs))
        for whole_row in (False, True):
            for v in (vals, _words(prio.long() + 7)):
                a, b = ts0.clone(), ts0.clone()
                K.ts_install_max(a, keys, groups, v, do_w, whole_row)
                ts_install_max_plain(b, keys, groups, v, do_w, whole_row)
                checks["ts_install_max"].compare([a], [b])
        # The slice-2 kernels, at this wave and at one whose claim tag has
        # its top bit clear, with and without live ops in the mask.
        none = torch.zeros_like(do_w)
        lane = prio[:, 0].contiguous()
        tables = {wave: (cw0, wts0),
                  HIGH_WAVE: make_tables(N, G, HIGH_WAVE, dev, si + 7)[::2]}
        for wv, (cw_, wts_) in tables.items():
            for inst, chk in ((do_w, check_w), (none, none)):
                a, b = wts_.clone(), wts_.clone()
                K.commit_install(a, keys, groups, inst)
                commit_install_plain(b, keys, groups, inst)
                checks["commit_install"].compare([a], [b])
                a, b = cw_.clone(), cw_.clone()
                K.claim_scatter(a, keys, groups, prio, wv, inst)
                claim_scatter_plain(b, keys, groups, prio, wv, inst)
                checks["claim_scatter"].compare([a], [b])
                checks["validate_dual"].compare(
                    K.validate_dual(cw_, keys, groups, prio, chk, wv),
                    validate_dual_plain(cw_, keys, groups, prio, chk, wv))
                # AutoGran's form: the install, then both verdicts.
                a, b = cw_.clone(), cw_.clone()
                checks["validate_dual"].compare(
                    [*K.validate_dual(a, keys, groups, lane, chk, wv,
                                      install=inst), a],
                    [*validate_dual_plain(b, keys, groups, lane, chk, wv,
                                          inst), b])
                for fine in (True, False):
                    a, b = cw_.clone(), cw_.clone()
                    checks["claim_probe"].compare(
                        [K.claim_probe(a, keys, groups, prio, wv, inst,
                                       fine), a],
                        [claim_probe_plain(b, keys, groups, prio, wv, inst,
                                           fine), b])
            # The probe alone, on the unclaimed, stale and live words of
            # this wave's table and on keys past the table's end.
            past = torch.where(check_w2, N + 5, keys)
            for k in (keys, past):
                for fine in (True, False):
                    checks["probe"].compare(
                        [K.probe(cw_, k, groups, wv, fine)],
                        [probe_plain(cw_, k, groups, inv_wave(wv),
                                     fine).to(torch.int32)])
        del tables
        # The folded forms at this shape: TicToc's three installs (the
        # stamps from commit_ts and the chain counts) and claim_probe on
        # both claim tables, at both tag halves.
        g = torch.Generator(device=dev)
        g.manual_seed(si)
        chain = dict(commit_ts=torch.randint(0, 1 << 32, (T,), generator=g,
                                             device=dev),
                     n_chain=segment_count_plain(keys, groups, G, do_w))
        for fine in (True, False):
            a, b = [wts0.clone(), ts0.clone()], [wts0.clone(), ts0.clone()]
            K.ts_install_max(a[0], keys, groups, None, do_w, rts=a[1],
                             ext=check_r, ext_whole_row=not fine, **chain)
            ts_install_tictoc_plain(b[0], keys, groups, do_w, b[1], check_r,
                                    not fine, **chain)
            checks["ts_install_max"].compare(a, b)
        pairs = {wave: (cw0, cr0),
                 HIGH_WAVE: make_tables(N, G, HIGH_WAVE, dev, si + 7)[:2]}
        for wv, (cw_, cr_) in pairs.items():
            for fine in (True, False):
                a, b = [cw_.clone(), cr_.clone()], [cw_.clone(), cr_.clone()]
                got = K.claim_probe(a[0], keys, groups, prio, wv, do_w, fine,
                                    claim_r=a[1], mask_r=do_r)
                want = [claim_probe_plain(b[0], keys, groups, prio, wv, do_w,
                                          fine),
                        claim_probe_plain(b[1], keys, groups, prio, wv, do_r,
                                          fine)]
                checks["claim_probe"].compare([*got, *a], [*want, *b])
        del pairs
        scan_mv_checks(checks, dev, N, G, keys, groups, prio, masks, wave,
                       seed=si, ext_cap=SCAN_KW.get(label, {}).get(
                           "scan_len", 9))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

        # ---- timings at this shape (OCC-fine's wave_commit call) -------
        n = T * Kk
        cw, wt = cw0.clone(), wts0.clone()
        # Every timed call sees the same post-install table (min is
        # idempotent), so this call's verdicts are those of every call.
        _, commit = K.wave_commit(
            cw.clone(), None, wt.clone(), keys, groups, prio, do_w, None,
            check_w, None, None, None, wave, True, False, True)
        everyone = torch.ones_like(do_w)
        installs = _distinct(keys, groups, do_w, G, N)
        bumps = _distinct(keys, groups, do_w & commit[:, None], G, N)
        # Op vectors in (keys, groups, prio: 4 B; do_w, check_w: 1 B),
        # conflict bytes and lane verdicts out; each claim cell the fine
        # probe or the install touches read once, each installed cell
        # written once; wts read and written once per committed write.
        wave_bytes = (n * (4 + 4 + 4 + 1 + 1 + 1) + T
                      + _distinct(keys, groups, everyone, G, N) * 4
                      + installs * 4 + bumps * 8)
        seg_bytes = n * (4 + 4 + 1 + 4)
        gather_bytes = n * (4 + 4 + 4) + _distinct(
            keys, groups, everyone, G, N) * 4
        inst_bytes = n * (4 + 4 + 4 + 1) + 2 * 4 * installs
        ok = (keys >= 0) & (keys < N)
        cells = (keys.long() * G + groups.long())
        cells_live = cells[ok]
        seg_cells = torch.where(do_w, cells, -1).reshape(-1)
        ins_cells = cells[do_w & ok]
        # Timestamps below 2**31, where int32 amax is uint32 max.
        ts_vals = (prio + 7).contiguous()
        ins_vals = ts_vals[do_w & ok]
        ts_flat = ts0.clone().view(-1)
        wts_flat = wts0.clone().view(-1)
        cw_flat = cw0.clone().view(-1)
        ins_ones = torch.ones_like(ins_cells, dtype=torch.int32)
        ins_words = _words(claim_word(wave, prio))[do_w & ok]
        probed = _distinct(keys, groups, everyone, G, N)
        checked_rows = _distinct_rows(keys, check_w, N)
        t = {
            "wave_commit": dict(
                ms=time_ms(lambda: K.wave_commit(
                    cw, None, wt, keys, groups, prio, do_w, None, check_w,
                    None, None, None, wave, True, False, True), dev),
                plain_ms=time_ms(lambda: wave_commit_plain(
                    cw, None, wt, keys, groups, prio, do_w, None, check_w,
                    None, None, None, wave, True, False, True), dev),
                library_ms=None,
                bound=bound_ms(wave_bytes, 10 * n)),
            "segment_count": dict(
                ms=time_ms(lambda: K.segment_count(keys, groups, G, do_w),
                           dev),
                plain_ms=time_ms(lambda: segment_count_plain(
                    keys, groups, G, do_w), dev),
                library_ms=time_ms(lambda: torch.unique(
                    seg_cells, return_inverse=True, return_counts=True),
                    dev),
                # A sort-based count: n log2 n compares.
                bound=bound_ms(seg_bytes, n * math.log2(n))),
            "ts_gather_one": dict(
                form="one table",
                ms=time_ms(lambda: K.ts_gather(ts0, keys, groups, True),
                           dev),
                plain_ms=time_ms(lambda: ts_gather_plain(
                    ts0, keys, groups, True), dev),
                library_ms=time_ms(lambda: torch.take(ts0, cells_live),
                                   dev),
                bound=bound_ms(gather_bytes, 0)),
            # One table, the values given (the parent's TicToc made three
            # such calls a wave).
            "ts_install_max_one": dict(
                form="one table, the values given",
                ms=time_ms(lambda: K.ts_install_max(
                    ts0, keys, groups, ts_vals, do_w, False), dev),
                plain_ms=time_ms(lambda: ts_install_max_plain(
                    ts0, keys, groups, ts_vals, do_w, False), dev),
                library_ms=time_ms(lambda: ts_flat.scatter_reduce_(
                    0, ins_cells, ins_vals, "amax"), dev),
                bound=bound_ms(inst_bytes, 0)),
            # Op vectors in (keys, groups: 4 B; do: 1 B), one word read and
            # written per distinct bumped cell.
            "commit_install": dict(
                ms=time_ms(lambda: K.commit_install(wt, keys, groups, do_w),
                           dev),
                plain_ms=time_ms(lambda: commit_install_plain(
                    wt, keys, groups, do_w), dev),
                library_ms=time_ms(lambda: wts_flat.index_add_(
                    0, ins_cells, ins_ones), dev),
                bound=bound_ms(n * (4 + 4 + 1) + installs * 8, n)),
            # Keys, groups, prio in, mask byte; a word read and written per
            # distinct installed cell.  The library call's int32 amin is
            # not the unsigned order: it stands for the same work only.
            "claim_scatter": dict(
                ms=time_ms(lambda: K.claim_scatter(
                    cw, keys, groups, prio, wave, do_w), dev),
                plain_ms=time_ms(lambda: claim_scatter_plain(
                    cw, keys, groups, prio, wave, do_w), dev),
                library_ms=time_ms(lambda: cw_flat.scatter_reduce_(
                    0, ins_cells, ins_words, "amin"), dev),
                bound=bound_ms(n * (4 + 4 + 4 + 1) + installs * 8, n)),
            # Op vectors in, two verdict bytes out, one G-word row read per
            # distinct checked record.
            "validate_dual_check": dict(
                form="the check alone, a priority per op",
                ms=time_ms(lambda: K.validate_dual(
                    cw, keys, groups, prio, check_w, wave), dev),
                plain_ms=time_ms(lambda: validate_dual_plain(
                    cw, keys, groups, prio, check_w, wave), dev),
                library_ms=None,
                bound=bound_ms(n * (4 + 4 + 4 + 1 + 2)
                               + checked_rows * G * 4, n * G)),
            # Keys and groups in, a 4-byte answer out, a word read per
            # distinct probed cell.
            "probe": dict(
                ms=time_ms(lambda: K.probe(cw, keys, groups, wave, True),
                           dev),
                plain_ms=time_ms(lambda: probe_plain(
                    cw, keys, groups, inv_wave(wave), True), dev),
                library_ms=None,
                bound=bound_ms(n * (4 + 4 + 4) + probed * 4, n)),
        }
        t.update(scan_mv_timings(label, dev, N, G, T, Kk, keys, groups,
                                 prio, do_w, wave))
        t.update(validate_install_timings(label, dev, N, G, T, Kk, keys,
                                          groups, prio, masks, wave))
        t.update(tictoc_probe_timings(label, dev, N, G, T, Kk, keys, groups,
                                      prio, masks, wave))
        t.update(gather_fold_timings(label, dev, N, G, T, Kk, keys, groups,
                                     prio, masks, wave))
        t.update(dual_install_timings(label, dev, N, G, T, Kk, keys, groups,
                                      prio, masks, wave))
        timings[label] = t
    timings["seg"] = segment_count_case_checks(checks["segment_count"],
                                               dev)
    iterate_validate_case_checks(checks["iterate_validate"], dev)
    wave_commit_case_checks(checks["wave_commit"], dev)
    validate_pair_case_checks(checks["validate"], dev)
    validate_install_case_checks(checks["validate"], dev)
    mv_install_case_checks(checks["mv_install"], dev)
    ts_install_case_checks(checks["ts_install_max"], dev)
    claim_probe_case_checks(checks["claim_probe"], dev)
    ts_gather_case_checks(checks["ts_gather"], dev)
    ring_fold_case_checks(checks, dev)
    bump_fold_case_checks(checks["iterate_validate"], dev)
    dual_install_case_checks(checks["validate_dual"], dev)
    dist_kernel_checks(checks, dev, dist_lanes)
    verdict_fold_case_checks(checks, dev)
    route_pack_case_checks(checks["route_pack"], dev)
    timings["dist"] = dist_kernel_timings(dev, dist_lanes)
    # The fold timings' tables at YCSB's 10M records on the card; a CPU
    # rehearsal takes 2**16 (its times are no device metric).
    timings["dist"].update(verdict_fold_timings(
        dev, dist_lanes, N=YCSB_N if dev.type == "cuda" else 1 << 16))
    timings.setdefault("tpcc", {}).update(apply_values_checks(
        checks["apply_values"], dev, apply_shapes))
    for label, t in timings.items():
        for name, r in t.items():
            plain = ("-" if r["plain_ms"] is None
                     else f"{r['plain_ms']:.4f}")
            log(f"  {label:5s} {name:16s} kernel {r['ms']:.6f} ms  plain "
                f"{plain} ms  library "
                f"{'-' if r['library_ms'] is None else '%.4f' % r['library_ms']}"
                f" ms  bound {r['bound'][0]:.7f} ms ({r['bound'][1]})"
                + (f"  without the ring {r['noring_ms']:.6f} ms"
                   if "noring_ms" in r else "")
                + (f"  without the words {r['nowords_ms']:.6f} ms"
                   if "nowords_ms" in r else "")
                + (f"  the chain it replaces {r['chain_ms']:.6f} ms"
                   if "chain_ms" in r else "")
                + (f"  split launches {r['split_ms']:.6f} ms"
                   if "split_ms" in r else ""))
    for c in checks.values():
        log(f"  {c.name:15s} {c.cases} cases vs plain: equal={c.equal} "
            f"max_abs_err={c.max_err}")
        if not c.equal:
            raise AssertionError(f"{c.name} disagrees with its plain "
                                 f"version (max_abs_err {c.max_err})")
    return checks, timings


# ------------------------------------------- scan and ring kernel checks
#: Install timestamps of the rings' second variant: they cross 2**31.
HIGH_TS = 0x7FFFFFF8


def scan_extents(keys, N, ext_cap, seed):
    """Interval starts and extents for the ops of ``make_ops``: 40% point
    ops, the rest scans of 2..ext_cap whose start moves back by up to its
    extent (so hot records fall inside), plus intervals that cross the
    table's end and one whose key lies past it."""
    rng = np.random.default_rng(seed + 100)
    k = keys.cpu().numpy().astype(np.int64)
    ext = np.where(rng.random(k.shape) < 0.4, 1,
                   rng.integers(2, ext_cap + 1, k.shape))
    start = np.where((k >= 0) & (ext > 1),
                     np.maximum(k - rng.integers(0, ext), 0), k)
    start[0, :3] = [N - 3, N - 1, N + 1]
    ext[0, :3] = ext_cap
    dev = keys.device
    return (torch.from_numpy(start.astype(np.int32)).to(dev),
            torch.from_numpy(ext.astype(np.int32)).to(dev))


def post_install_claims(N, G, wave, keys, groups, prio, do_w, dev, seed):
    """A writer-claim table as the phantom pass sees it: words of earlier
    waves everywhere, plus this wave's installed write claims."""
    from repro_torch.kernels.claim_scatter import claim_scatter_plain
    table = make_tables(N, G, max(wave - 4, 0), dev, seed)[0]
    claim_scatter_plain(table, keys, groups, prio, wave, do_w)
    return table


def ring(N, D, G, keys, groups, do, dev, base=0, waves=12):
    """A version ring after ``waves`` waves of installs (stamps base + 1,
    base + 2, ...), each wave's ops rolled so that records differ: hot
    records wrap, most keep empty slots."""
    from repro_torch.core.mvstore import mv_init
    from repro_torch.kernels.mv_install import mv_install_plain
    begin, head, _ = mv_init(N, D, G, dev)
    for w in range(1, waves + 1):
        mv_install_plain(begin, head, torch.roll(keys, w), groups, do,
                         base + w)
    return begin, head


def scan_mv_checks(checks, dev, N, G, keys, groups, prio, masks, wave, seed,
                   ext_cap):
    """The slice-3 kernels against their plain versions, every case."""
    from repro_torch import kernels as K
    from repro_torch.kernels.claim_probe import claim_probe_verdict_plain
    from repro_torch.kernels.iterate_validate import iterate_validate_plain
    from repro_torch.kernels.mv_gather import mv_gather_plain
    from repro_torch.kernels.mv_install import mv_install_plain
    from repro_torch.kernels.occ_validate import validate_plain
    do_w, do_r, check_w, check_w2, check_r, extra = masks
    none = torch.zeros_like(do_w)
    lane = prio[:, 0].contiguous()
    starts, ext = scan_extents(keys, N, ext_cap, seed)
    hits = []
    for wv in (wave, HIGH_WAVE):
        dense, dense_r, wts = make_tables(N, G, wv, dev, seed + 11)[:3]
        for fine in (True, False):
            for chk in (check_w, none):
                checks["validate"].compare(
                    [K.validate(dense, keys, groups, prio, chk, wv, fine)],
                    [validate_plain(dense, keys, groups, prio, chk, wv,
                                    fine)])
            # Two channels: overlapping masks, disjoint ones, one empty.
            for cw_, cr_ in ((check_w, check_r), (check_w & ~check_r,
                                                  check_r), (none, check_r)):
                pair = dict(claim_r=dense_r, check_r=cr_)
                checks["validate"].compare(
                    [K.validate(dense, keys, groups, prio, cw_, wv, fine,
                                **pair)],
                    [validate_plain(dense, keys, groups, prio, cw_, wv,
                                    fine, **pair)])
            # The installs and the check in one call: both installs and
            # both checks, installs into one table only with one check,
            # and nothing at all.
            for iw, ir, cw_, cr_ in ((do_w, do_w & check_w, check_w,
                                      check_r),
                                     (do_w, none, none, check_r),
                                     (none, none, none, none)):
                outs = []
                for fn in (K.validate, validate_plain):
                    a, b = dense.clone(), dense_r.clone()
                    outs.append([fn(a, keys, groups, lane, cw_, wv, fine,
                                    claim_r=b, check_r=cr_, install_w=iw,
                                    install_r=ir), a, b])
                checks["validate"].compare(*outs)
        table = post_install_claims(N, G, wv, keys, groups, prio, do_w, dev,
                                    seed + 13)
        for fine in (True, False):
            for B in (8, 1):
                for chk in (check_r, none):
                    got = K.iterate_validate(table, starts, ext, groups,
                                             prio, chk, wv, fine, B, ext_cap)
                    checks["iterate_validate"].compare(
                        [got], [iterate_validate_plain(
                            table, starts, ext, groups, prio, chk, wv, fine,
                            B, ext_cap)])
                    hits.append(int(got.sum()))
                # The bump form: point conflicts with the scan checks,
                # none without them; the writes bump.
                pt = check_w if chk is check_r else none
                outs = []
                for fn in (K.iterate_validate, iterate_validate_plain):
                    w_ = wts.clone()
                    outs.append([fn(table, starts, ext, groups, prio, chk,
                                    wv, fine, B, ext_cap, point=pt, wts=w_,
                                    do=do_w), w_])
                checks["iterate_validate"].compare(*outs)
        del dense, dense_r, wts, table
    log(f"  iterate_validate conflicts per case: {hits}")
    if not max(hits) > 0:
        raise AssertionError("iterate_validate: no case had a conflict")
    groups_x = groups.clone()
    groups_x[0, :4] = G             # out of range: reads begin 0 when fine
    pw = (do_w & check_w).contiguous()
    for base in (0, HIGH_TS):
        begin, _ = ring(N, MV_DEPTH, G, keys, groups, do_w, dev, base)
        for ts in (base + 12, base + 6, base + 3, 0):
            for fine in (True, False):
                checks["mv_gather"].compare(
                    K.mv_gather(begin, keys, groups_x, ts, fine),
                    mv_gather_plain(begin, keys, groups_x, ts, fine))
        # The ring read folded into the MV waves' validate (installs, check)
        # and the sharded owner's two-table claim_probe (its verdict form).
        ring_kw = dict(begin=begin, snap_ts=base + 6)
        cw0, cr0 = make_tables(N, G, wave, dev, seed + 17)[:2]
        for fine in (True, False):
            outs = []
            for fn in (K.validate, validate_plain):
                a, b = cw0.clone(), cr0.clone()
                res = fn(a, keys, groups_x, lane, check_w, wave, fine,
                         claim_r=b, check_r=check_r, install_w=do_w,
                         install_r=pw, **ring_kw)
                outs.append([*res, a, b])
            checks["validate"].compare(*outs)
            a, b = [cw0.clone(), cr0.clone()], [cw0.clone(), cr0.clone()]
            got = K.claim_probe(a[0], keys, groups_x, prio, wave, do_w, fine,
                                claim_r=a[1], mask_r=pw, **ring_kw,
                                is_r=do_r, is_rp=check_r)
            want = claim_probe_verdict_plain(
                b[0], keys, groups_x, prio, wave, do_w, fine, b[1], pw,
                begin, base + 6, do_r, check_r)
            checks["claim_probe"].compare([got, *a], [want, *b])
        del begin, cw0, cr0
    for D in (MV_DEPTH, 1):
        begin, head = ring(N, D, G, keys, groups, do_w, dev)
        hot = keys[keys >= 0][:4].long()
        head[hot] = D - 1           # rings that wrap on this install
        for do in (do_w, do_r, none):
            a, b = (begin.clone(), head.clone()), (begin.clone(),
                                                   head.clone())
            K.mv_install(*a, keys, groups, do, 13)
            mv_install_plain(*b, keys, groups, do, 13)
            checks["mv_install"].compare(list(a), list(b))
        del begin, head


def _covered_rows(keys, ext, check, N, B, span):
    """Distinct table rows that the checked ops' bucket-expanded (coarse)
    intervals cover."""
    act = check & (keys >= 0)
    k = keys[act].long()
    e = torch.clamp(ext[act], min=1).long()
    start = (k // B) * B
    width = ((k + e + B - 1) // B) * B - start
    j = torch.arange(span, device=keys.device)
    row = start[:, None] + j[None, :]
    on = (j[None, :] < width[:, None]) & (row < N)
    return int(torch.unique(row[on]).numel())


def scan_mv_timings(label, dev, N, G, T, Kk, keys, groups, prio, do_w, wave):
    """Times of iterate_validate, mv_gather and mv_install on one wave of
    the scan path: the scan-configured workload's draw at the main shapes,
    else the synthetic ops.  Returns {name: timing dict}."""
    from repro_torch import kernels as K
    from repro_torch.kernels.iterate_validate import (iterate_validate_plain,
                                                      scan_span)
    from repro_torch.kernels.mv_gather import mv_gather_plain
    from repro_torch.kernels.mv_install import mv_install_plain
    from repro_torch.launch.txn_bench import make_workload
    ext_cap, ext = 9, None
    if label in SCAN_KW:
        wl = make_workload(label, **SCAN_KW[label])
        if (wl.n_records, wl.slots) != (N, Kk):
            raise ValueError(f"{label}: shape {(N, Kk)} is not the "
                             f"workload's {(wl.n_records, wl.slots)}")
        g = torch.Generator(device=dev)
        g.manual_seed(7)
        b, _ = wl.gen(g, wave, T, torch.zeros((wl.n_rings,),
                                              dtype=torch.int32, device=dev))
        keys, groups, ext = b.op_key, b.op_group, b.op_extent
        live = b.live()
        do_w = b.is_write() & live
        scan = b.is_scan() & b.is_read() & live
        reads = b.is_read() & live & ~b.is_scan()
        ext_cap = wl.max_extent
    else:
        _, ext = scan_extents(keys, N, ext_cap, 0)
        scan = (ext > 1) & (keys >= 0)
        reads = ~scan & ~do_w & (keys >= 0)
    n = T * Kk
    span = scan_span(ext_cap, False, 8)
    table = post_install_claims(N, G, wave, keys, groups, prio, do_w, dev, 5)
    begin, head = ring(N, MV_DEPTH, G, keys, groups, do_w, dev, waves=6)
    rows_scanned = _covered_rows(keys, ext, scan, N, 8, span)
    rows_live = _distinct_rows(keys, torch.ones_like(do_w), N)
    rows_written = _distinct_rows(keys, do_w, N)
    # Each call stamps above the last, as successive waves do, reading its
    # stamp from device memory (a 0-d view of one arange, made before the
    # timed calls).
    stamps = torch.arange(101, 101 + 4096, dtype=torch.int64, device=dev)
    ts = [100]

    def install(fn):
        ts[0] += 1
        fn(begin, head, keys, groups, do_w, stamps[ts[0] - 101])
    log(f"  {label:5s} scan wave: {int(scan.sum())} scans over "
        f"{rows_scanned} rows (coarse span {span}), {rows_written} written "
        f"records")
    scan_args = (table, keys, ext, groups, prio, scan, wave, False, 8,
                 ext_cap)
    out = {
        # Coarse (the widest walk): op vectors in (keys, extents, groups,
        # prio: 4 B; check: 1 B), a verdict byte out, each distinct row of
        # the checked bucket-expanded intervals read once.
        "iterate_validate": dict(
            ms=time_ms(lambda: K.iterate_validate(*scan_args), dev),
            plain_ms=time_ms(lambda: iterate_validate_plain(*scan_args),
                             dev),
            library_ms=None,
            bound=bound_ms(n * (4 * 4 + 1 + 1) + rows_scanned * G * 4,
                           rows_scanned * G)),
        # Keys and groups in, a slot and a flag out, the D x G begin words
        # of each distinct live record read once.
        "mv_gather": dict(
            ms=time_ms(lambda: K.mv_gather(begin, keys, groups, 7, True),
                       dev),
            plain_ms=time_ms(lambda: mv_gather_plain(
                begin, keys, groups, 7, True), dev),
            library_ms=None,
            bound=bound_ms(n * (4 + 4 + 4 + 1)
                           + rows_live * MV_DEPTH * G * 4,
                           n * MV_DEPTH * G)),
        # Keys, groups, mask in; per distinct written record the head read
        # and written and one G-word slot read and one written.
        "mv_install": dict(
            ms=time_ms(lambda: install(K.mv_install), dev),
            plain_ms=time_ms(lambda: install(mv_install_plain), dev),
            library_ms=None,
            bound=bound_ms(n * (4 + 4 + 1) + rows_written * (8 + 2 * G * 4),
                           n)),
    }
    # The bump form on the same wave: the point conflicts of its reads
    # (their check on the post-install table), its writes bump; beside the
    # chain it replaces (the phantom launch, the OR, any, NOT and mask, and
    # commit_install) on this build.
    from repro_torch.kernels.occ_validate import validate_plain
    point = validate_plain(table, keys, groups, prio, reads, wave, False)
    wts = make_tables(N, G, wave, dev, 6)[2]
    bump = dict(point=point, wts=wts, do=do_w)
    commit = ~(iterate_validate_plain(*scan_args) | point).any(dim=1)
    bumps = _distinct(keys, groups, do_w & commit[:, None], G, N)

    def chain(phantom, install):
        c = phantom(*scan_args) | point
        install(wts, keys, groups, do_w & ~c.any(dim=1)[:, None])
    # iterate_validate's bytes, a point and a write-mask byte an op, a word
    # read and written per distinct bumped cell.
    out["iterate_validate_bump"] = dict(
        ms=time_ms(lambda: K.iterate_validate(*scan_args, **bump), dev),
        plain_ms=time_ms(lambda: iterate_validate_plain(*scan_args, **bump),
                         dev),
        chain_ms=time_ms(lambda: chain(K.iterate_validate,
                                       K.commit_install), dev),
        library_ms=None,
        bound=bound_ms(n * (4 * 4 + 1 + 1 + 1 + 1) + rows_scanned * G * 4
                       + bumps * 8, rows_scanned * G + n),
        form=("a scan wave's phantom pass and its version bumps in one "
              "launch"),
        shape=(f"{label} scan wave, T={T} K={Kk} N={N} G={G}, coarse "
               f"B=8 span {span}"),
        point=int(point.sum()), committed=int(commit.sum()),
        bumped_cells=bumps)
    return out


def dual_install_timings(label, dev, N, G, T, Kk, keys, groups, prio, masks,
                         wave):
    """Times of validate_dual's install form (AutoGran's write-claim
    install and both verdicts in one cooperative launch) on an AutoGran
    wave of the main path's workload at the main shapes (else the
    synthetic ops: installs at do_w, checks at check_w), beside the chain
    it replaces (two [T, K] copies of the lane priority, claim_scatter and
    validate_dual: ``chain_ms`` on this build).  Every call installs into
    the same table (min is idempotent).  Returns {name: timing dict}."""
    from repro_torch import kernels as K
    from repro_torch.kernels.occ_validate import validate_dual_plain
    from repro_torch.launch.txn_bench import make_workload
    if label in MAIN_KW:
        wl = make_workload(label, **MAIN_KW[label])
        if (wl.n_records, wl.slots) != (N, Kk):
            raise ValueError(f"{label}: shape {(N, Kk)} is not the "
                             f"workload's {(wl.n_records, wl.slots)}")
        g = torch.Generator(device=dev)
        g.manual_seed(17)
        b, _ = wl.gen(g, wave, T, torch.zeros((wl.n_rings,),
                                              dtype=torch.int32, device=dev))
        keys, groups = b.op_key, b.op_group
        live = b.live()
        inst = b.is_write() & live
        check = b.is_read() & live & ~b.is_scan()
    else:
        inst, check = masks[0], masks[2]
    n = T * Kk
    lane = prio[:, 0].contiguous()
    cw = make_tables(N, G, wave, dev, 19)[0]
    args = (cw, keys, groups, lane, check, wave)

    def chain(scatter, dual):
        scatter(cw, keys, groups, lane[:, None].expand(keys.shape)
                .contiguous(), wave, inst)
        return dual(cw, keys, groups, lane[:, None].expand(keys.shape)
                    .contiguous(), check, wave)
    installs = _distinct(keys, groups, inst, G, N)
    rows = _distinct_rows(keys, check, N)
    # Keys, groups (4 B) and two mask bytes in, two verdict bytes out an
    # op, the lane priority 4 B a lane; a word read and written per
    # distinct installed cell, a G-word row read per distinct checked
    # record.
    out = {"validate_dual": dict(
        ms=time_ms(lambda: K.validate_dual(*args, install=inst), dev),
        plain_ms=time_ms(lambda: validate_dual_plain(*args, inst), dev),
        chain_ms=time_ms(lambda: chain(K.claim_scatter, K.validate_dual),
                         dev),
        library_ms=None,
        bound=bound_ms(n * (4 + 4 + 1 + 1 + 2) + 4 * T + installs * 8
                       + rows * G * 4, n + n * G),
        form=("AutoGran's one launch: the write-claim install and both "
              "verdicts"),
        shape=f"{label} AutoGran wave, T={T} K={Kk} N={N} G={G}",
        installed=int(inst.sum()), checked=int(check.sum()))}
    return out


#: The multi-version path's workloads (benchmarks/abort_rates.py's YCSB
#: mix: 80% writes, 20% read-only transactions).
MV_KW = {"tpcc": dict(scale=1.0),
         "ycsb": dict(n_keys=YCSB_N, theta=0.9, write_frac=0.8,
                      ro_frac=0.2)}


def validate_install_timings(label, dev, N, G, T, Kk, keys, groups, prio,
                             masks, wave):
    """Times of validate with the wave's claim installs and ring read, on
    the masks the multi-version waves build: one launch (MV-OCC's masks:
    every write installs into claim_w and plain writes into claim_r; plain
    writes and update-transaction point reads are checked on claim_w,
    ADDs on claim_r; MVCC's without the reads; every op reads the ring at
    the wave's snapshot), beside the same call without the ring
    (``noring_ms``), this build's install form and mv_gather (the launches
    the waves made before, ``split_ms``).  The multi-version workload's
    draw at the
    main shapes, else the synthetic ops; every call installs into the
    same tables (min is idempotent, so each call sees the tables of the
    first).  Returns {name: timing dict}."""
    from repro_torch import kernels as K
    from repro_torch.kernels.occ_validate import validate_plain
    from repro_torch.launch.txn_bench import make_workload
    if label in MV_KW:
        wl = make_workload(label, **MV_KW[label])
        if (wl.n_records, wl.slots) != (N, Kk):
            raise ValueError(f"{label}: shape {(N, Kk)} is not the "
                             f"workload's {(wl.n_records, wl.slots)}")
        g = torch.Generator(device=dev)
        g.manual_seed(11)
        b, _ = wl.gen(g, wave, T, torch.zeros((wl.n_rings,),
                                              dtype=torch.int32, device=dev))
        keys, groups = b.op_key, b.op_group
        live = b.live()
        do_w = b.is_write() & live
        pw = b.is_plain_write() & live
        ad = b.is_add() & live
        has_write = do_w.any(dim=1)
        reads = b.is_read() & live & ~b.is_scan() & has_write[:, None]
    else:
        do_w, do_r, check_w, _, check_r, _ = masks
        pw, ad = check_w & do_w, check_r & ~do_w
        do_w = pw | ad
        reads = do_r & ~do_w
    n = T * Kk
    lane = prio[:, 0].contiguous()
    tables = make_tables(N, G, max(wave - 4, 0), dev, 5)[:2]
    begin, _ = ring(N, MV_DEPTH, G, keys, groups, do_w, dev, waves=6)
    snap = 3
    rows_live = _distinct_rows(keys, torch.ones_like(do_w), N)
    out = {}
    for name, check_w in (("validate", pw | reads), ("validate_mvcc", pw)):
        cw, cr = (t.clone() for t in tables)
        inst = dict(claim_r=cr, check_r=ad, install_w=do_w, install_r=pw)
        ring_kw = dict(begin=begin, snap_ts=snap)
        args = (cw, keys, groups, lane, check_w, wave, True)

        def run_split(install, gather, args=args, inst=inst):
            install(*args, **inst)
            gather(begin, keys, groups, snap, True)
        # Op vectors in (keys, groups: 4 B; four masks: 1 B each), the lane
        # priority (4 B a lane), a verdict and a flag byte out; a word read
        # and written per distinct installed cell of each table, one G-word
        # row read per distinct record each channel checks, the D x G ring
        # words of each distinct live record read once.
        cells = (_distinct(keys, groups, do_w, G, N)
                 + _distinct(keys, groups, pw, G, N))
        rows = (_distinct_rows(keys, check_w, N)
                + _distinct_rows(keys, ad, N))
        out[name] = dict(
            ms=time_ms(lambda: K.validate(*args, **inst, **ring_kw), dev),
            plain_ms=time_ms(lambda: validate_plain(*args, **inst,
                                                    **ring_kw), dev),
            noring_ms=time_ms(lambda: K.validate(*args, **inst), dev),
            split_ms=time_ms(lambda: run_split(K.validate, K.mv_gather),
                             dev),
            library_ms=None,
            bound=bound_ms(n * (4 + 4 + 4 * 1 + 2) + 4 * T + cells * 8
                           + rows * G * 4 + rows_live * MV_DEPTH * G * 4,
                           4 * n + n * MV_DEPTH * G),
            form=("the multi-version wave's one launch: both claim "
                  "installs, the two-channel check and the ring read"),
            shape=(f"{label} {'MV-OCC' if name == 'validate' else 'MVCC'} "
                   f"wave masks, T={T} K={Kk} N={N} G={G} D={MV_DEPTH}, "
                   f"fine"),
            installed=[int(do_w.sum()), int(pw.sum())],
            checked=[int(check_w.sum()), int(ad.sum())])
    log(f"  {label:5s} MV wave masks: {int(do_w.sum())} writes, "
        f"{int(pw.sum())} plain writes, {int(ad.sum())} ADDs, "
        f"{int(reads.sum())} update-transaction point reads")
    return out


def tictoc_probe_timings(label, dev, N, G, T, Kk, keys, groups, prio, masks,
                         wave):
    """Times of two folded forms on the synthetic wave: TicToc's three
    installs as one ts_install_max launch (the stamps computed in the
    kernel from commit_ts and the chain counts; committed writes at do_w,
    extensions at do_r & ~do_w), with the fine extension and with the
    coarse one (``ts_install_max_coarse``: every group of the record),
    beside this build's one-table launch three times on the precomputed
    stamps (``split_ms``); claim_probe on one table (one cooperative
    launch); claim_probe on two tables (``claim_probe_pair``: writer
    claims at do_w, reader claims at do_r) beside this build's one-table
    launch twice (``split_ms``).  Every timed claim call installs into the
    same
    tables (min is idempotent), every ts call into the same (max is).
    Returns {name: timing dict}."""
    from repro_torch import kernels as K
    from repro_torch.kernels.claim_probe import claim_probe_plain
    from repro_torch.kernels.ts_install import (chain_stamps,
                                                ts_install_tictoc_plain)
    do_w, do_r = masks[0], masks[1]
    ext = (do_r & ~do_w).contiguous()
    n = T * Kk
    g = torch.Generator(device=dev)
    g.manual_seed(17)
    commit_ts = torch.randint(0, 1 << 32, (T,), generator=g, device=dev)
    n_chain = K.segment_count(keys, groups, G, do_w)
    stamps = chain_stamps(commit_ts, n_chain)
    cw0, cr0, wts, ts = make_tables(N, G, wave, dev, 23)
    rts = ts.clone()
    wcells = _distinct(keys, groups, do_w, G, N)
    out = {}
    for name, coarse in (("ts_install_max", False),
                         ("ts_install_max_coarse", True)):
        tt = (rts, ext, coarse, commit_ts, n_chain)

        def split_ts(fn, coarse=coarse):
            fn(wts, keys, groups, stamps, do_w, False)
            fn(rts, keys, groups, stamps, do_w, False)
            fn(rts, keys, groups, stamps, ext, coarse)
        # rts cells installed into: the committed writes' cells, and the
        # extensions' cells (fine) or every cell of their rows (coarse).
        ok = ext & (keys >= 0) & (keys < N)
        ext_cells = (keys[ok].long()[:, None] * G
                     + torch.arange(G, device=dev)) if coarse else \
            keys[ok].long() * G + groups[ok].long()
        wok = do_w & (keys >= 0) & (keys < N)
        rcells = int(torch.unique(torch.cat(
            [keys[wok].long() * G + groups[wok].long(),
             ext_cells.reshape(-1)])).numel())
        out[name] = dict(
            ms=time_ms(lambda tt=tt: K.ts_install_max(
                wts, keys, groups, None, do_w, rts=tt[0], ext=tt[1],
                ext_whole_row=tt[2], commit_ts=tt[3], n_chain=tt[4]), dev),
            plain_ms=time_ms(lambda tt=tt: ts_install_tictoc_plain(
                wts, keys, groups, do_w, *tt), dev),
            split_ms=time_ms(lambda f=split_ts: f(K.ts_install_max), dev),
            # No one PyTorch call installs into two tables.
            library_ms=None,
            # Keys, groups, chain counts (4 B), two mask bytes an op,
            # commit_ts (8 B a lane); a word read and written per distinct
            # wts cell and rts cell installed into.
            bound=bound_ms(n * (4 + 4 + 4 + 1 + 1) + 8 * T
                           + 8 * (wcells + rcells), 0),
            form=("TicToc's three installs in one launch: wts and rts at "
                  "the committed writes, rts at the extensions"
                  + (", each extension's whole row" if coarse else "")),
            shape=(f"{label} T={T} K={Kk} N={N} G={G}, "
                   f"{'coarse' if coarse else 'fine'}"),
            installed=[int(do_w.sum()), int(ext.sum())])

    cw, cr = cw0.clone(), cr0.clone()
    probed = _distinct(keys, groups, torch.ones_like(do_w), G, N)
    one = dict(
        ms=time_ms(lambda: K.claim_probe(cw, keys, groups, prio, wave, do_w,
                                         True), dev),
        plain_ms=time_ms(lambda: claim_probe_plain(
            cw, keys, groups, prio, wave, do_w, True), dev),
        library_ms=None,
        # Fine probe: op vectors in, a 4-byte answer out, a word read per
        # distinct probed cell and written per installed cell.
        bound=bound_ms(n * (4 + 4 + 4 + 1 + 4) + probed * 4
                       + _distinct(keys, groups, do_w, G, N) * 4, 2 * n),
        shape=f"{label} T={T} K={Kk} N={N} G={G}, fine")
    pair = dict(
        ms=time_ms(lambda: K.claim_probe(cw, keys, groups, prio, wave, do_w,
                                         True, claim_r=cr, mask_r=do_r),
                   dev),
        plain_ms=time_ms(lambda: (
            claim_probe_plain(cw, keys, groups, prio, wave, do_w, True),
            claim_probe_plain(cr, keys, groups, prio, wave, do_r, True)),
            dev),
        split_ms=time_ms(lambda: (
            K.claim_probe(cw, keys, groups, prio, wave, do_w, True),
            K.claim_probe(cr, keys, groups, prio, wave, do_r, True)), dev),
        library_ms=None,
        # Keys, groups, prio, two mask bytes and two answers an op; per
        # table a word read per distinct probed cell and written per
        # installed cell.
        bound=bound_ms(n * (4 + 4 + 4 + 1 + 1 + 4 + 4) + 2 * probed * 4
                       + (_distinct(keys, groups, do_w, G, N)
                          + _distinct(keys, groups, do_r, G, N)) * 4, 4 * n),
        shape=f"{label} two tables, T={T} K={Kk} N={N} G={G}, fine")
    out["claim_probe"] = one
    out["claim_probe_pair"] = pair
    return out


#: The main path's workload settings (its TicToc wave in the kernel phase).
MAIN_KW = {"tpcc": dict(scale=1.0),
           "ycsb": dict(n_keys=YCSB_N, theta=0.9, write_frac=0.5)}


def gather_fold_timings(label, dev, N, G, T, Kk, keys, groups, prio, masks,
                        wave):
    """Times of the gather folds: TicToc's observation (ts_gather's TicToc
    form: both tables to commit_ts and ext_need in one launch), fine and
    coarse (``ts_gather_coarse``), on a TicToc wave of the main path's
    workload at the main shapes (else the synthetic ops: reads at do_r,
    writes at do_w), beside this build's one-table ts_gather twice and
    TicToc's torch arithmetic (what the wave ran before, ``split_ms``).
    Returns {name: timing dict}."""
    from repro_torch import kernels as K
    from repro_torch.kernels.ts_gather import tictoc_observe_plain
    from repro_torch.launch.txn_bench import make_workload
    do_w, do_r = masks[0], masks[1]
    n = T * Kk
    wts, rts = make_tables(N, G, wave, dev, 29)[2:]
    if label in MAIN_KW:
        wl = make_workload(label, **MAIN_KW[label])
        if (wl.n_records, wl.slots) != (N, Kk):
            raise ValueError(f"{label}: shape {(N, Kk)} is not the "
                             f"workload's {(wl.n_records, wl.slots)}")
        g = torch.Generator(device=dev)
        g.manual_seed(13)
        b, _ = wl.gen(g, wave, T, torch.zeros((wl.n_rings,),
                                              dtype=torch.int32, device=dev))
        okeys, ogroups, extent = b.op_key, b.op_group, b.op_extent
        live = b.live()
        rd, wr = b.is_read() & live, b.is_write() & live
    else:
        okeys, ogroups, extent = keys, groups, torch.ones_like(keys)
        rd, wr = do_r, do_w
    obs = dict(rd=rd, wr=wr, extent=extent)
    everyone = torch.ones_like(do_w)
    out = {}
    for name, fine in (("ts_gather", True), ("ts_gather_coarse", False)):
        gargs = (wts, rts, okeys, ogroups, fine)
        # Keys, groups, extents (4 B) and two mask bytes in, a flag byte
        # out an op, commit_ts 8 B a lane; a word (fine) or a row (coarse)
        # of each table read per distinct live cell or record.
        words = (_distinct(okeys, ogroups, everyone, G, N) if fine else
                 _distinct_rows(okeys, everyone, N) * G)
        out[name] = dict(
            ms=time_ms(lambda f=fine: K.ts_gather(wts, okeys, ogroups, f,
                                                  rts=rts, **obs), dev),
            plain_ms=time_ms(lambda a=gargs: tictoc_observe_plain(*a, **obs),
                             dev),
            split_ms=time_ms(lambda a=gargs: tictoc_observe_plain(
                *a, **obs, gather=K.ts_gather), dev),
            library_ms=None,
            bound=bound_ms(n * (4 + 4 + 4 + 1 + 1 + 1) + 8 * T
                           + 2 * words * 4, 4 * n),
            form=("TicToc's observation: wts and rts to commit_ts and "
                  "ext_need in one launch"),
            shape=(f"{label} TicToc wave, T={T} K={Kk} N={N} G={G}, "
                   f"{'fine' if fine else 'coarse'}"),
            ops=[int(rd.sum()), int(wr.sum())])

    return out


# ------------------------------------------- sharded-wave kernel checks
def _dist_cap(lanes, slots, n_dest, scans):
    """DistConfig's automatic capacity for one rank routing ``lanes``
    lanes to ``n_dest`` shards."""
    from repro_torch.core.distributed import DistConfig
    return DistConfig(n_records=1 << 20, lanes_per_shard=lanes, slots=slots,
                      max_extent=2 if scans else 1).cap(n_dest)


def _route_inputs(M, n_dest, dev, seed, skew=False):
    """Owners (a tenth masked: n_dest, -1 or past n_dest; ``skew`` sends
    every live op to destination 0) and three int32 channels."""
    rng = np.random.default_rng(seed)
    owner = rng.integers(0, n_dest, M)
    if skew:
        owner[:] = 0
    pick = rng.random(M)
    owner = np.where(pick < 0.1, rng.choice([n_dest, -1, n_dest + 5], M),
                     owner)
    vals = rng.integers(-2 ** 31, 2 ** 31, (3, M), dtype=np.int64)
    return (torch.from_numpy(owner.astype(np.int32)).to(dev),
            torch.from_numpy(vals.astype(np.int32)).to(dev))


def _verdict_bytes(D, M, dev, seed):
    """int8 verdict rows with every 2-bit pattern, and negative bytes."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-128, 128, (D, M)).astype(
        np.int8)).to(dev)


def _wide_ops(N, G, T, K, dev, seed):
    """make_ops' wave reshaped to [T, K] rows of many lanes each, with a
    prio per op, as the sharded owner's rows of one source shard."""
    keys, groups, _, masks, _ = make_ops(N, G, T, K, dev, seed)
    rng = np.random.default_rng(seed + 1)
    prio = torch.from_numpy(rng.integers(0, 1 << 16, (T, K)).astype(
        np.int32)).to(dev)
    return keys, groups, prio, masks


def dist_kernel_checks(checks, dev, lanes=DIST_LANES, slots=16):
    """route_pack, verdict_pack, verdict_unpack and wide-row wave_commit
    against their plain versions at the sharded wave's shapes: M = lanes
    x slots ops (x 2 with scans) routed to 1 and 8 shards at DistConfig's
    capacity, a forced drop (cap 16) and a skewed wave that overflows its
    destination, masked owners; verdict rows whose length is not a
    multiple of 16 and words with bit 31 set; wave_commit on one row of
    the one-card capacity (16,384 ops; 32,768 with scans) and on 8 rows."""
    from repro_torch import kernels as K
    from repro_torch.core.distributed import LANE_FILL, META_FILL, NO_OP
    from repro_torch.kernels.route_pack import route_pack_plain
    from repro_torch.kernels.verdict_pack import (verdict_pack_plain,
                                                  verdict_unpack_plain)
    from repro_torch.kernels.wave_commit import wave_commit_plain
    fills = (NO_OP, META_FILL, LANE_FILL)
    dropped, negative = [], 0
    for scans in (False, True):
        M = lanes * slots * (2 if scans else 1)
        for n_dest in (1, 8):
            cap = _dist_cap(lanes, slots, n_dest, scans)
            for case, (c, skew) in enumerate(((cap, False), (16, False),
                                              (cap, True))):
                owner, vals = _route_inputs(M, n_dest, dev, 31 * case + M,
                                            skew)
                got = K.route_pack(owner, vals, n_dest, c, fills)
                checks["route_pack"].compare(
                    got, route_pack_plain(owner, vals, n_dest, c, fills))
                dropped.append(int((~got[2] & (owner >= 0)
                                    & (owner < n_dest)).sum()))
            for D in {1, n_dest}:
                for m in (cap, cap - 5, 37):
                    v = _verdict_bytes(D, m, dev, m + D)
                    words = K.verdict_pack(v)
                    negative += int((words < 0).sum())
                    checks["verdict_pack"].compare(
                        [words], [verdict_pack_plain(v)])
                    checks["verdict_unpack"].compare(
                        [K.verdict_unpack(words, m)],
                        [verdict_unpack_plain(words, m)])
                rng = np.random.default_rng(cap + D)
                words = torch.from_numpy(rng.integers(
                    -2 ** 31, 2 ** 31, (D, cap // 16)).astype(np.int32)).to(
                        dev)
                for n in (cap, cap - 3):
                    checks["verdict_unpack"].compare(
                        [K.verdict_unpack(words, n)],
                        [verdict_unpack_plain(words, n)])
    log(f"  route_pack dropped ops per case: {dropped}; verdict words with "
        f"bit 31 set: {negative}")
    if not (min(dropped) == 0 and max(dropped) > 0 and negative > 0):
        raise AssertionError("route_pack/verdict_pack cases must include "
                             "drops, drop-free waves and bit 31")
    N, G, wave = 1 << 20, 2, 9
    cw0, cr0, wts0, _ = make_tables(N, G, wave, dev, seed=3)
    for T, Kk in ((1, _dist_cap(lanes, slots, 1, False)),
                  (1, _dist_cap(lanes, slots, 1, True)),
                  (8, _dist_cap(lanes, slots, 8, False))):
        keys, groups, prio, masks = _wide_ops(N, G, T, Kk, dev, T + Kk)
        do_w, do_r, check_w, check_w2, check_r, extra = masks
        for fine in (True, False):
            for dual, bump in ((False, False), (True, True), (False, True)):
                outs = []
                for fn in (K.wave_commit, wave_commit_plain):
                    cw, cr, wt = cw0.clone(), cr0.clone(), wts0.clone()
                    conflict, commit = fn(
                        cw, cr, wt, keys, groups, prio, do_w, do_r, check_w,
                        check_w2, check_r if dual else None, None, wave,
                        fine, dual, bump)
                    outs.append((conflict, commit, cw, cr, wt))
                checks["wave_commit"].compare(*outs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dist_kernel_timings(dev, lanes=DIST_LANES, slots=16, wave=9):
    """Times of the sharded wave's kernels at the one-card shapes (one
    destination, M = lanes x slots ops, cap 16,384), and of wave_commit on
    that one wide row.  Returns {name: timing dict}."""
    from repro_torch import kernels as K
    from repro_torch.core.distributed import LANE_FILL, META_FILL, NO_OP
    from repro_torch.kernels.route_pack import route_pack_plain
    from repro_torch.kernels.verdict_pack import (verdict_pack_plain,
                                                  verdict_unpack_plain)
    from repro_torch.kernels.wave_commit import wave_commit_plain
    fills = (NO_OP, META_FILL, LANE_FILL)
    M, cap = lanes * slots, _dist_cap(lanes, slots, 1, False)
    owner, vals = _route_inputs(M, 1, dev, 5)
    live = int(((owner >= 0) & (owner < 1)).sum())
    cap8 = _dist_cap(lanes, slots, 8, False)
    owner8, vals8 = _route_inputs(M, 8, dev, 7)
    v = _verdict_bytes(1, cap, dev, 6)
    words = K.verdict_pack(v)
    N, G = YCSB_N, 2
    cw0, _, wts0, _ = make_tables(N, G, wave, dev, seed=4)
    keys, groups, prio, masks = _wide_ops(N, G, 1, cap, dev, 8)
    do_w, check_w = masks[0], masks[2]
    cw = cw0.clone()
    everyone = torch.ones_like(do_w)
    wave_bytes = (cap * (4 + 4 + 4 + 1 + 1 + 1) + 1
                  + _distinct(keys, groups, everyone, G, N) * 4
                  + _distinct(keys, groups, do_w, G, N) * 4)
    wide_args = (cw, None, None, keys, groups, prio, do_w, None, check_w,
                 None, None, None, wave, True, False, False)
    out = {
        # Owner and three channels in, the buffer, pos and took out; one
        # compare per op.
        "route_pack": dict(
            ms=time_ms(lambda: K.route_pack(owner, vals, 1, cap, fills),
                       dev),
            plain_ms=time_ms(lambda: route_pack_plain(owner, vals, 1, cap,
                                                      fills), dev),
            library_ms=None,
            bound=bound_ms(M * 4 + 3 * M * 4 + 3 * cap * 4 + M * 4 + M, M),
            live_ops=live, shape=f"M={M} n_dest=1 cap={cap} W=3"),
        # The same wave routed to 8 shards.
        "route_pack_8": dict(
            ms=time_ms(lambda: K.route_pack(owner8, vals8, 8, cap8, fills),
                       dev),
            plain_ms=time_ms(lambda: route_pack_plain(owner8, vals8, 8,
                                                      cap8, fills), dev),
            library_ms=None,
            bound=bound_ms(M * 4 + 3 * M * 4 + 3 * 8 * cap8 * 4 + M * 4 + M,
                           M),
            shape=f"M={M} n_dest=8 cap={cap8} W=3"),
        "verdict_pack": dict(
            ms=time_ms(lambda: K.verdict_pack(v), dev),
            plain_ms=time_ms(lambda: verdict_pack_plain(v), dev),
            library_ms=None,
            bound=bound_ms(cap + cap // 16 * 4, cap),
            shape=f"[1, {cap}] int8"),
        "verdict_unpack": dict(
            ms=time_ms(lambda: K.verdict_unpack(words, cap), dev),
            plain_ms=time_ms(lambda: verdict_unpack_plain(words, cap), dev),
            library_ms=None,
            bound=bound_ms(cap // 16 * 4 + cap, cap),
            shape=f"[1, {cap // 16}] int32"),
        # The owner's fused claim on one wide row, without bump (as the
        # sharded owner calls it).
        "wave_commit_wide": dict(
            ms=time_ms(lambda: K.wave_commit(*wide_args), dev),
            plain_ms=time_ms(lambda: wave_commit_plain(*wide_args), dev),
            library_ms=None, bound=bound_ms(wave_bytes, 10 * cap),
            shape=f"[1, {cap}]"),
    }
    return out



# ------------------------------------------- verdict folds (sharded wave)
#: verdict_fold_cases' shapes: (label, D source rows, cap ops a row, mode,
#: scans, fine, G).  cap % 16 of 0 and 8 and cap = 8 (one partial word a
#: row, so words straddle rows), 1, 3 and 8 rows, the one-card row
#: (16,384 ops) and its scan row (32,768), rows of empty cells, all-conflict
#: rows, scan fragments ORing into shared words, and 8 rows of 40,968 ops:
#: more ops than an H100 keeps co-resident threads (and wave_commit's
#: 128-op chunks more units than its resident grid), so the grids stride.
VERDICT_FOLD_SHAPES = (
    ("cap%16=0 ns=1", 1, 64, "mixed", False, True, 2),
    ("cap%16=8 ns=3", 3, 40, "mixed", True, False, 2),
    ("cap=8 ns=8", 8, 8, "mixed", True, True, 2),
    ("cap%16=8 ns=8 G=1", 8, 2056, "mixed", True, False, 1),
    ("one-card row", 1, 16384, "mixed", False, True, 2),
    ("one-card scan row", 1, 32768, "mixed", True, False, 2),
    ("empty rows", 3, 24, "empty", False, True, 2),
    ("all-conflict rows", 2, 40, "conflict", False, False, 2),
    ("scan fragments, shared words", 3, 40, "scan_or", True, True, 2),
    ("past the resident grid", 8, 40968, "mixed", True, True, 2),
)
#: The scan fragments' widest interval in the fold cases (max_extent).
FOLD_EXT_CAP = 8


def _route_np(owner, D, cap, lane_of_op):
    """route_pack's placement in numpy: (pos int32[M], took bool[M], the
    lane channel int32[D, cap] with LANE_FILL in cells no op fills)."""
    M = owner.shape[0]
    pos = np.zeros(M, np.int32)
    lane = np.full((D, cap), -1, np.int32)
    valid = (owner >= 0) & (owner < D)
    idx = np.flatnonzero(valid)
    order = np.argsort(owner[idx], kind="stable")
    o = owner[idx][order]
    pos[idx[order]] = np.arange(o.size) - np.searchsorted(o, o)
    took = valid & (pos < cap)
    lane[owner[took], pos[took]] = lane_of_op[took]
    return pos, took, lane


def _fold_case(rng, ci, D, cap, mode, scans, fine, G, N=None, T=None):
    """One verdict_fold_cases entry's dict (see there); ``ci`` picks the
    claim-tag half and the ring's stamp side, ``N`` the records (997 for
    small rows, 2**16 above 4,096 ops by default) and ``T`` the sender's
    lanes (by default as many as fill the D rows)."""
    n = D * cap
    if N is None:
        N = 997 if n < 4096 else 1 << 16
    wave = HIGH_WAVE if ci % 2 else 9
    base = HIGH_TS if ci % 4 >= 2 else 0
    W = -(-cap // 16)
    keys = _hot_keys(rng, N, D, cap)
    groups = rng.integers(0, G, (D, cap))
    kind = rng.choice([0, 1, 2, 3], (D, cap), p=[0.1, 0.5, 0.3, 0.1])
    width = np.where(rng.random((D, cap)) < 0.4,
                     rng.integers(1, FOLD_EXT_CAP + 1, (D, cap)), 0)
    claim_w = claim_words(rng, N, G, wave, 0.3)
    claim_r = claim_words(rng, N, G, wave, 0.3)
    begin = rng.integers(base + 1, base + 21, (N, 4, G)).astype(np.uint32)
    begin[rng.random((N, 4, G)) < 0.3] = 0xFFFFFFFF
    begin[1] = base + 11 + np.arange(4 * G).reshape(4, G)     # reclaimed
    prio = rng.integers(1, 1 << 16, (D, cap))
    if mode == "empty":
        keys[:] = -1
    elif mode == "conflict":
        # Point reads of claimed cells, each claim live and stronger than
        # every op, every stamp newer than the snapshot.
        kind[:], width[:] = 1, 0
        keys = np.where(keys < 0, 0, keys % N)
        claim_w[:] = claim_r[:] = _live_word(wave, 0)
        begin[:] = base + 11
    elif mode == "scan_or":
        # Scan fragments only, over hot claimed rows: several conflicting
        # fragments share each word.
        kind[:] = 1
        width = rng.integers(1, FOLD_EXT_CAP + 1, (D, cap))
        keys = rng.integers(0, 16, (D, cap))
        claim_w[:16] = _live_word(wave, 0)
    live = keys >= 0
    prio = np.where(live, prio, 0xFFFF)
    is_r = live & (kind == 1)
    is_sc = is_r & (width > 0) if scans else np.zeros((D, cap), bool)
    cwords = rng.integers(-2 ** 31, 2 ** 31, (D, W)).astype(np.int32)
    cwords[:, ::3] = 0                           # words that bump nothing
    # The sender: T lanes of K ops routed to the D rows at cap.
    K = 32 if scans else 16
    T = T or max(1, -(-n // K))
    M = T * K
    owner = rng.integers(0, D, M)
    owner[rng.random(M) < 0.3] = 0               # row 0 may overflow
    owner = np.where(rng.random(M) < 0.1, rng.choice([D, -1, D + 5], M),
                     owner)
    pos, took, lane = _route_np(owner, D, cap,
                                (np.arange(M) // K).astype(np.int32))
    return dict(
        D=D, cap=cap, wave=wave, fine=fine, scans=scans,
        keys=keys.astype(np.int32), groups=groups.astype(np.int32),
        prio=prio.astype(np.int32), is_w=live & ((kind == 2) | (kind == 3)),
        is_pw=live & (kind == 2), is_r=is_r, is_sc=is_sc,
        is_rp=is_r & ~is_sc, ext=np.maximum(width, 1).astype(np.int32),
        claim_w=claim_w, claim_r=claim_r,
        wts=rng.integers(0, 1 << 32, (N, G), dtype=np.uint64).astype(
            np.uint32),
        begin=begin, head=rng.integers(0, 4, N).astype(np.int32),
        snap_ts=base + 10, ts=base + 40, cwords=cwords,
        owner=owner.astype(np.int32), pos=pos, took=took, lane=lane,
        vwords=rng.integers(-2 ** 31, 2 ** 31, (D, W)).astype(np.int32),
        commit=rng.random(T) < 0.6)


def verdict_fold_cases(seed=83):
    """The owner's and the sender's folded verdict forms, made with numpy
    from ``seed``: [(label, dict)] per VERDICT_FOLD_SHAPES entry.  Owner
    side, rows of ``cap`` cells as they arrive: keys int32[D, cap] (-1 for
    an empty cell, a fifth on four hot rows, some past N), groups, the
    cell priority prio16, the masks the wave decodes (is_w every write,
    is_pw the plain WRITEs, is_r every read, is_sc the scan fragments,
    is_rp the point reads), the fragments' extents ext; the pre-install
    claim tables claim_w and claim_r uint32[N, G] (stale, empty and live
    words; all live and stronger than every op in the all-conflict rows),
    wts, the version ring begin uint32[N, 4, G] and head int32[N] (empty
    slots, a reclaimed record; every stamp postdating the snapshot in the
    all-conflict rows), snap_ts, the install stamp ts, and arrived commit
    words cwords int32[D, ceil(cap/16)] (every 2-bit pattern, bit 31 set).
    Sender side, T lanes of 16 ops (32 with scans) routed to the D rows at
    ``cap`` (a tenth masked, some rows overflowing, some underfilled):
    owner, pos and took int32/bool[M] as route_pack gives them, the lane
    channel lane int32[D, cap] (LANE_FILL -1), the arrived verdict words
    vwords and the lanes' commit bool[T]."""
    rng = np.random.default_rng(seed)
    cases = []
    for ci, (label, D, cap, mode, scans, fine, G) in enumerate(
            VERDICT_FOLD_SHAPES):
        c = _fold_case(rng, ci, D, cap, mode, scans, fine, G)
        cases.append((f"{label} D={D} cap={cap} {mode} "
                      f"{'fine' if fine else 'coarse'} G={G}"
                      f"{' scans' if scans else ''} wave={c['wave']}", c))
    return cases


def _claim_args(a, c):
    return (a["keys"], a["groups"], a["prio"], c["wave"])


def verdict_fold_case_checks(checks, dev):
    """Every folded form against its plain version, the chain of plain ops
    it replaces, on verdict_fold_cases: wave_commit's packed words and its
    installed table, claim_probe's verdict form on one table and on two
    with the ring (words and both tables), iterate_validate ORing into
    bit 0 and bit 1 of those words, commit_install and mv_install reading
    commit words (wts; the ring and heads), and the sender's gather forms
    of verdict_unpack and verdict_pack.  Some case must have words with
    bit 31 set, fields of every value, all-conflict words and at least
    two scan fragments OR-ed into one word."""
    from repro_torch import kernels as K
    from repro_torch.kernels.claim_probe import claim_probe_verdict_plain
    from repro_torch.kernels.iterate_validate import iterate_validate_plain
    from repro_torch.kernels.mv_install import mv_install_plain
    from repro_torch.kernels.occ_commit import commit_install_plain
    from repro_torch.kernels.verdict_pack import (verdict_pack_gather_plain,
                                                  verdict_pack_plain,
                                                  verdict_unpack_gather_plain)
    from repro_torch.kernels.wave_commit import wave_commit_plain
    cases = verdict_fold_cases()
    fields = set()
    negative = full = shared = 0
    for label, c in cases:
        a, b = _case_tensors(c, dev), _case_tensors(c, dev)
        # Owner: OCC's fused claim, then its scans into bit 0.
        got, commit = K.wave_commit(
            a["claim_w"], None, None, a["keys"], a["groups"], a["prio"],
            a["is_w"], None, a["is_rp"], None, None, None, c["wave"],
            c["fine"], False, False, pack=True)
        conflict, want_commit = wave_commit_plain(
            b["claim_w"], None, None, b["keys"], b["groups"], b["prio"],
            b["is_w"], None, b["is_rp"], None, None, None, c["wave"],
            c["fine"], False, False)
        want = verdict_pack_plain(conflict.to(torch.int8))
        checks["wave_commit"].compare([got, commit, a["claim_w"]],
                                      [want, want_commit, b["claim_w"]])
        iv = (a["claim_w"], a["keys"], a["ext"], a["groups"], a["prio"],
              a["is_sc"], c["wave"], c["fine"], 8, FOLD_EXT_CAP)
        phantom = iterate_validate_plain(*iv)
        for bit in (0, 1):
            w0 = got.clone()
            checks["iterate_validate"].compare(
                [K.iterate_validate(*iv, words=w0, bit=bit)],
                [got | verdict_pack_plain(phantom.to(torch.int8) << bit)])
        per_word = torch.nn.functional.pad(
            phantom.to(torch.int32), (0, -c["cap"] % 16)).view(
                c["D"], -1, 16).sum(dim=-1)
        shared += int((per_word >= 2).sum())
        # Owner: the unfused OCC claim (one table).
        a, b = _case_tensors(c, dev), _case_tensors(c, dev)
        got = K.claim_probe(a["claim_w"], *_claim_args(a, c), a["is_w"],
                            c["fine"], is_rp=a["is_rp"])
        want = claim_probe_verdict_plain(
            b["claim_w"], *_claim_args(b, c), b["is_w"], c["fine"], None,
            None, None, None, None, b["is_rp"])
        checks["claim_probe"].compare([got, a["claim_w"]],
                                      [want, b["claim_w"]])
        # Owner: the MV claim (two tables and the ring).
        a, b = _case_tensors(c, dev), _case_tensors(c, dev)
        got = K.claim_probe(a["claim_w"], *_claim_args(a, c), a["is_w"],
                            c["fine"], claim_r=a["claim_r"],
                            mask_r=a["is_pw"], begin=a["begin"],
                            snap_ts=c["snap_ts"], is_r=a["is_r"],
                            is_rp=a["is_rp"])
        want = claim_probe_verdict_plain(
            b["claim_w"], *_claim_args(b, c), b["is_w"], c["fine"],
            b["claim_r"], b["is_pw"], b["begin"], c["snap_ts"], b["is_r"],
            b["is_rp"])
        checks["claim_probe"].compare([got, a["claim_w"], a["claim_r"]],
                                      [want, b["claim_w"], b["claim_r"]])
        u = want.to(torch.int64) & 0xFFFFFFFF
        for f in range(16):
            fields |= set(((u >> (2 * f)) & 3).unique().tolist())
        negative += int((want < 0).sum())
        full += int((want == -1).sum())
        # Owner: the installs through the arrived commit words.
        K.commit_install(a["wts"], a["keys"], a["groups"], a["is_w"],
                         words=a["cwords"])
        commit_install_plain(b["wts"], b["keys"], b["groups"], b["is_w"],
                             b["cwords"])
        checks["commit_install"].compare([a["wts"]], [b["wts"]])
        K.mv_install(a["begin"], a["head"], a["keys"], a["groups"],
                     a["is_w"], c["ts"], words=a["cwords"])
        mv_install_plain(b["begin"], b["head"], b["keys"], b["groups"],
                         b["is_w"], c["ts"], b["cwords"])
        checks["mv_install"].compare([a["begin"], a["head"]],
                                     [b["begin"], b["head"]])
        # Sender: the verdicts at the routing coordinates, the commit bits
        # through the lane channel.
        checks["verdict_unpack"].compare(
            [K.verdict_unpack(a["vwords"], c["cap"], owner=a["owner"],
                              pos=a["pos"], took=a["took"])],
            [verdict_unpack_gather_plain(b["vwords"], c["cap"], b["owner"],
                                         b["pos"], b["took"])])
        checks["verdict_pack"].compare(
            [K.verdict_pack(a["commit"], lane=a["lane"])],
            [verdict_pack_gather_plain(b["commit"], b["lane"])])
    log(f"  verdict-fold cases: {len(cases)} (the largest "
        f"{max(c['keys'].size for _, c in cases)} ops); MV verdict fields "
        f"{sorted(fields)}, words with bit 31 {negative}, all-conflict "
        f"words {full}; words holding >= 2 scan conflicts {shared}")
    if not (fields == {0, 1, 2, 3} and negative and full and shared):
        raise AssertionError("verdict folds: the cases must reach every "
                             "field value, bit 31, all-conflict words and "
                             "scan conflicts sharing a word")


def _gather_chain(unpack, words, n, owner, pos, took):
    """The sender's verdict chain before the gather form: the parent
    route's clamped int64 coordinates, the full-row unpack (``unpack``),
    the gather and the mask."""
    D = words.shape[0]
    vv = unpack(words, n)[torch.clamp(owner, 0, D - 1).to(torch.int64),
                          torch.clamp(pos, 0, n - 1).to(torch.int64)]
    return torch.where(took, vv, 0)


def _lane_chain(pack, commit, lane):
    """The sender's commit-bit chain before the gather form."""
    T = commit.shape[0]
    return pack(torch.where(
        lane >= 0, commit[torch.clamp(lane, 0, T - 1).to(torch.int64)]
        .to(torch.int8), 0))


def _mv_verdicts(wprio, rprio, ok, prio, is_w, is_pw, is_r, is_rp):
    """The sharded MV owner's verdict bytes from the two-table
    claim_probe's answers and mv_gather's ok, as the wave computed them
    before the verdict form."""
    is_ad = is_w & ~is_pw
    uncond = ((is_pw & (wprio < prio)) | (is_ad & (rprio < prio))
              | (is_r & ~ok))
    rdval = is_rp & (wprio < prio)
    return uncond.to(torch.int8) | (rdval.to(torch.int8) << 1)


def verdict_fold_timings(dev, lanes=DIST_LANES, slots=16, N=YCSB_N):
    """Times of the folded verdict forms at the one-card sharded shapes
    (one row of cap 16,384 ops, 32,768 with scans, on YCSB's 10M records;
    the sender's lanes x slots ops): each form (``ms``) beside the chain
    it replaces on this build's kernels (``chain_ms``; for the two-table
    claim with the ring, the answer-form claim, mv_gather, the verdict
    bits and the pack), the claim and install launches beside the same
    call without the words (``nowords_ms``; the two-table claim with the
    ring beside the answer form without the ring, ``noring_ms``).
    Returns {form: timing dict}."""
    from repro_torch import kernels as K
    from repro_torch.kernels.claim_probe import claim_probe_verdict_plain
    from repro_torch.kernels.iterate_validate import (iterate_validate_plain,
                                                      scan_span)
    from repro_torch.kernels.mv_install import mv_install_plain
    from repro_torch.kernels.occ_commit import commit_install_plain
    from repro_torch.kernels.verdict_pack import (verdict_pack_gather_plain,
                                                  verdict_unpack_gather_plain,
                                                  verdict_unpack_plain)
    from repro_torch.kernels.wave_commit import wave_commit_plain
    rng = np.random.default_rng(89)
    cap = _dist_cap(lanes, slots, 1, False)
    cap_s = _dist_cap(lanes, slots, 1, True)
    c = _case_tensors(_fold_case(rng, 0, 1, cap, "mixed", False, True, 2,
                                 N=N, T=lanes), dev)
    cs = _case_tensors(_fold_case(rng, 0, 1, cap_s, "mixed", True, False,
                                  2, N=N), dev)
    T, M, W = c["commit"].shape[0], c["owner"].shape[0], cap // 16
    wave, snap = c["wave"], c["snap_ts"]
    kr = (c["keys"], c["groups"], c["prio"])
    wc = (c["claim_w"], None, None, *kr, c["is_w"], None, c["is_rp"],
          None, None, None, wave, True, False, False)
    pair = dict(claim_r=c["claim_r"], mask_r=c["is_pw"])
    ring = dict(**pair, begin=c["begin"], snap_ts=snap)
    iv = (cs["claim_w"], cs["keys"], cs["ext"], cs["groups"], cs["prio"],
          cs["is_sc"], cs["wave"], False, 8, FOLD_EXT_CAP)
    ws = torch.zeros((1, cap_s // 16), dtype=torch.int32, device=dev)
    vs = torch.zeros((1, cap_s), dtype=torch.int8, device=dev)
    everyone = torch.ones_like(c["is_w"])
    cells = _distinct(c["keys"], c["groups"], everyone, 2, N)
    installs = _distinct(c["keys"], c["groups"], c["is_w"], 2, N)
    bumps = _distinct(c["keys"], c["groups"], c["is_w"] & (
        verdict_unpack_plain(c["cwords"], cap) > 0), 2, N)
    records = _distinct_rows(c["keys"], everyone, N)
    covered = _covered_rows(cs["keys"], cs["ext"], cs["is_sc"], N, 8,
                            scan_span(FOLD_EXT_CAP, False, 8))
    unpack_fns = {"": K.verdict_unpack}
    pack_fns = {"": K.verdict_pack}

    def chains(fn_of):
        """chain_ms of ``fn_of(key)``, the chain on the pack or unpack of
        ``key``."""
        return {"chain_ms": time_ms(fn_of(""), dev)}

    out = {}
    # Owner, OCC fused: op vectors in (14 B an op), each probed cell read,
    # each installed cell written, a word a 16 ops out.
    out["wave_commit_pack"] = dict(
        ms=time_ms(lambda: K.wave_commit(*wc, pack=True), dev),
        nowords_ms=time_ms(lambda: K.wave_commit(*wc), dev),
        plain_ms=time_ms(lambda: wave_commit_plain(*wc, pack=True), dev),
        library_ms=None,
        bound=bound_ms(cap * 14 + (cells + installs) * 4 + W * 4 + 1,
                       10 * cap),
        shape=f"[1, {cap}]",
        **chains(lambda p: lambda: pack_fns[p](
            K.wave_commit(*wc)[0].to(torch.int8))))
    # Owner, OCC unfused: one table, the same bytes.
    out["claim_probe_verdict"] = dict(
        ms=time_ms(lambda: K.claim_probe(c["claim_w"], *kr, wave,
                                         c["is_w"], True, is_rp=c["is_rp"]),
                   dev),
        nowords_ms=time_ms(lambda: K.claim_probe(c["claim_w"], *kr, wave,
                                                 c["is_w"], True), dev),
        plain_ms=time_ms(lambda: claim_probe_verdict_plain(
            c["claim_w"], *kr, wave, c["is_w"], True, None, None, None,
            None, None, c["is_rp"]), dev),
        library_ms=None,
        bound=bound_ms(cap * 14 + (cells + installs) * 4 + W * 4, 6 * cap),
        shape=f"[1, {cap}] one table",
        **chains(lambda p: lambda: pack_fns[p]((
            c["is_rp"] & (K.claim_probe(c["claim_w"], *kr, wave, c["is_w"],
                                        True) < c["prio"]))
            .to(torch.int8))))
    # Owner, MVCC/MV-OCC: two tables and the ring; 16 B an op, both
    # tables' cells, D x G ring words a distinct record.
    out["claim_probe_verdict_ring"] = dict(
        ms=time_ms(lambda: K.claim_probe(
            c["claim_w"], *kr, wave, c["is_w"], True, **ring,
            is_r=c["is_r"], is_rp=c["is_rp"]), dev),
        noring_ms=time_ms(lambda: K.claim_probe(
            c["claim_w"], *kr, wave, c["is_w"], True, **pair), dev),
        plain_ms=time_ms(lambda: claim_probe_verdict_plain(
            c["claim_w"], *kr, wave, c["is_w"], True, c["claim_r"],
            c["is_pw"], c["begin"], snap, c["is_r"], c["is_rp"]), dev),
        library_ms=None,
        bound=bound_ms(cap * 16 + 2 * (cells + installs) * 4
                       + records * 4 * 2 * 4 + W * 4, 20 * cap),
        shape=f"[1, {cap}] two tables and the ring (D=4)",
        **chains(lambda p: lambda: pack_fns[p](
            _mv_verdicts(*K.claim_probe(c["claim_w"], *kr, wave, c["is_w"],
                                        True, **pair),
                         K.mv_gather(c["begin"], c["keys"], c["groups"],
                                     snap, True)[1], c["prio"],
                         c["is_w"], c["is_pw"], c["is_r"], c["is_rp"]))))
    # Owner, scans: 17 B an op in, each covered row's two words, the words
    # read and written.
    out["iterate_validate_words"] = dict(
        ms=time_ms(lambda: K.iterate_validate(*iv, words=ws, bit=0), dev),
        nowords_ms=time_ms(lambda: K.iterate_validate(*iv), dev),
        plain_ms=time_ms(lambda: iterate_validate_plain(*iv), dev),
        library_ms=None,
        bound=bound_ms(cap_s * 17 + covered * 8 + 2 * ws.numel() * 4,
                       4 * cap_s),
        shape=f"[1, {cap_s}] coarse, max_extent {FOLD_EXT_CAP}",
        chain_ms=time_ms(lambda: vs | K.iterate_validate(*iv).to(
            torch.int8), dev))
    # Owner installs: 9 B an op, the words, each bumped cell read and
    # written (ring: a head and two G-word slots a written record).
    inst = (c["keys"], c["groups"], c["is_w"])
    out["commit_install_words"] = dict(
        ms=time_ms(lambda: K.commit_install(c["wts"], *inst,
                                            words=c["cwords"]), dev),
        nowords_ms=time_ms(lambda: K.commit_install(c["wts"], *inst), dev),
        plain_ms=time_ms(lambda: commit_install_plain(
            c["wts"], *inst, c["cwords"]), dev),
        library_ms=None,
        bound=bound_ms(cap * 9 + W * 4 + bumps * 8, 3 * cap),
        shape=f"[1, {cap}]",
        **chains(lambda p: lambda: K.commit_install(
            c["wts"], c["keys"], c["groups"],
            c["is_w"] & (unpack_fns[p](c["cwords"], cap) > 0))))
    # Each call stamps above the last, as successive waves do, read from
    # device memory (0-d views of one arange made before the timed calls).
    stamps = torch.arange(c["ts"] + 1, c["ts"] + 1 + 8192,
                          dtype=torch.int64, device=dev)
    ts = [0]

    def stamp():
        ts[0] += 1
        return stamps[ts[0] - 1]
    ring_t = (c["begin"], c["head"], *inst)
    out["mv_install_words"] = dict(
        ms=time_ms(lambda: K.mv_install(*ring_t, stamp(),
                                        words=c["cwords"]), dev),
        nowords_ms=time_ms(lambda: K.mv_install(*ring_t, stamp()), dev),
        plain_ms=time_ms(lambda: mv_install_plain(*ring_t, stamp(),
                                                  c["cwords"]), dev),
        library_ms=None,
        bound=bound_ms(cap * 9 + W * 4 + bumps * (8 + 2 * 2 * 4), 3 * cap),
        shape=f"[1, {cap}] D=4",
        **chains(lambda p: lambda: K.mv_install(
            c["begin"], c["head"], c["keys"], c["groups"],
            c["is_w"] & (unpack_fns[p](c["cwords"], cap) > 0), stamp())))
    # Sender: 10 B an op and the words; the lane channel, a byte a lane
    # and the words.
    g = (c["vwords"], cap, c["owner"], c["pos"], c["took"])
    out["verdict_unpack_gather"] = dict(
        ms=time_ms(lambda: K.verdict_unpack(
            c["vwords"], cap, owner=c["owner"], pos=c["pos"],
            took=c["took"]), dev),
        plain_ms=time_ms(lambda: verdict_unpack_gather_plain(*g), dev),
        library_ms=None,
        bound=bound_ms(M * 10 + W * 4, 3 * M),
        shape=f"M={M} ops of [1, {W}] words",
        **chains(lambda p: lambda: _gather_chain(unpack_fns[p], *g)))
    out["verdict_pack_gather"] = dict(
        ms=time_ms(lambda: K.verdict_pack(c["commit"], lane=c["lane"]),
                   dev),
        plain_ms=time_ms(lambda: verdict_pack_gather_plain(
            c["commit"], c["lane"]), dev),
        library_ms=None,
        bound=bound_ms(cap * 4 + T + W * 4, 2 * cap),
        shape=f"lane [1, {cap}], T={T}",
        **chains(lambda p: lambda: _lane_chain(
            pack_fns[p], c["commit"], c["lane"])))
    return out


# --------------------------------------------------------------- main path
def _name(r) -> str:
    return f"{r['cc']}-{'fine' if r['granularity'] else 'coarse'}"


def _log_row(workload, r):
    log(f"  {workload} {_name(r):16s} commits {r['commits']:6d} aborts "
        f"{r['aborts']:6d} thpt {r['throughput']:.4f} txn/us  "
        f"{r['waves_per_s']:.1f} waves/s  "
        f"{r['waves'] * r['lanes'] / r['wall_s']:.0f} lane-txns/s  "
        f"causes {r['abort_causes']}  kernels {r['kernel_ops']}")
    if sum(r["abort_causes"].values()) != r["aborts"]:
        raise AssertionError(f"{_name(r)}: causes do not sum to aborts")
    if r["commits"] + r["aborts"] != r["lanes"] * r["waves"]:
        raise AssertionError(f"{_name(r)}: commits + aborts != T * waves")


def _check_kernels(what, rows, launches, dev, scans):
    """Each run launched exactly its mechanism's kernels ("cuda") and no
    other ported op ("not_run"); every kernel of the phase launched."""
    for r in rows:
        want = {op: "cuda" if op in mech_ops(r["cc"], scans) else "not_run"
                for op in r["kernel_ops"]}
        if dev.type == "cuda" and r["kernel_ops"] != want:
            raise AssertionError(f"{what} {_name(r)}: kernel_ops "
                                 f"{r['kernel_ops']} != {want}")
    log(f"  {what} launches {launches}")
    path_ops = {op for r in rows for op in mech_ops(r["cc"], scans)}
    if dev.type == "cuda" and min(launches[op] for op in path_ops) <= 0:
        raise AssertionError(f"{what}: a kernel never launched")
    # TicToc's three timestamp installs are one launch a wave, and so are
    # its two timestamp reads with commit_ts; the MV waves read the ring
    # inside validate.
    tictoc_waves = sum(r["waves"] for r in rows if r["cc"] == "tictoc")
    mv_waves = sum(r["waves"] for r in rows if r["cc"] in ("mvcc", "mvocc"))
    log(f"  {what} ts_install_max launches {launches['ts_install_max']}, "
        f"ts_gather {launches['ts_gather']} over {tictoc_waves} TicToc "
        f"waves; mv_gather {launches['mv_gather']} over {mv_waves} MV waves")
    if dev.type == "cuda" and not (
            launches["ts_install_max"] == launches["ts_gather"]
            == tictoc_waves and launches["mv_gather"] == 0):
        raise AssertionError(f"{what}: a TicToc wave must launch "
                             "ts_install_max and ts_gather once, an MV "
                             "wave mv_gather never")
    # An AutoGran wave is one validate_dual launch (its claims installed
    # in it); with scans every wave but MVCC's launches iterate_validate
    # once, the bumping waves in its bump form, so commit_install
    # launches only on AutoGran's point waves.
    auto_waves = sum(r["waves"] for r in rows if r["cc"] == "autogran")
    scan_waves = (sum(r["waves"] for r in rows if r["cc"] != "mvcc")
                  if scans else 0)
    want = {"validate_dual": auto_waves, "claim_scatter": 0,
            "iterate_validate": scan_waves,
            "commit_install": 0 if scans else auto_waves}
    got = {op: launches[op] for op in want}
    log(f"  {what} launches {got} over {auto_waves} AutoGran waves, "
        f"{scan_waves} waves that check scans")
    if dev.type == "cuda" and got != want:
        raise AssertionError(f"{what}: launches {got}, want {want}")


def main_path(workload, dev, waves=WAVES, lanes=LANES, **wl_kw):
    """Drive the grid runner of the benchmark CLI: the five probe-family
    mechanisms x coarse and fine, then AutoGran coarse.  Returns ({name:
    row}, launches during the run)."""
    from repro_torch import kernels as K
    from repro_torch.launch.txn_bench import run_grid
    K.reset_launches()
    rows = run_grid(workload, list(PROBE_FAMILY), (0, 1), [lanes], waves,
                    device=dev, **wl_kw)
    rows += run_grid(workload, ["autogran"], (0,), [lanes], waves,
                     device=dev, **wl_kw)
    launches = K.launch_counts()
    for r in rows:
        _log_row(workload, r)
    _check_kernels(workload, rows, launches, dev, scans=False)
    return {_name(r): r for r in rows}, launches


def scan_path(workload, dev, waves=WAVES, lanes=LANES, **wl_kw):
    """The main path with the workload's scan classes on: the probe
    family and MVCC/MV-OCC x coarse and fine, then AutoGran.  MVCC sees
    no phantom; coarse sees at least fine's phantoms for OCC, TicToc and
    MV-OCC (benchmarks/scan_mix.py).  Returns ({name: row}, launches)."""
    from repro_torch import kernels as K
    from repro_torch.launch.txn_bench import run_grid
    K.reset_launches()
    rows = run_grid(workload, list(PROBE_FAMILY) + ["mvcc", "mvocc"],
                    (0, 1), [lanes], waves, mv_depth=MV_DEPTH, device=dev,
                    **wl_kw)
    rows += run_grid(workload, ["autogran"], (0,), [lanes], waves,
                     device=dev, **wl_kw)
    launches = K.launch_counts()
    by = {}
    for r in rows:
        by[_name(r)] = r
        _log_row(f"{workload} scans", r)
        if r["max_extent"] != wl_kw["scan_len"]:
            raise AssertionError(f"{_name(r)}: max_extent {r['max_extent']}")
    _check_kernels(f"{workload} scans", rows, launches, dev, scans=True)
    ph = {k: r["abort_causes"]["phantom"] for k, r in by.items()}
    log(f"  {workload} phantom aborts: {ph}")
    if ph["mvcc-coarse"] or ph["mvcc-fine"]:
        raise AssertionError("MVCC scans must never abort as phantoms")
    for cc in ("occ", "tictoc", "mvocc"):
        if ph[f"{cc}-coarse"] < ph[f"{cc}-fine"]:
            raise AssertionError(f"{cc}: coarse phantoms < fine phantoms")
    return by, launches


def mv_path(dev, waves=WAVES, lanes=LANES, tpcc_kw=None, ycsb_kw=None):
    """The multi-version mechanisms at full size: MVCC/MV-OCC x coarse and
    fine on point TPC-C; OCC/MVCC/MV-OCC x coarse and fine on YCSB with
    80% writes and 20% read-only transactions; one MVCC run on YCSB with
    snapshots 8 waves old.  Read-only lanes never abort under MVCC/MV-OCC
    and do under coarse OCC; the aged snapshots abort as stale; every
    MVCC and MV-OCC wave launches validate (its claim installs, check and
    ring read) once, mv_install once and claim_scatter and mv_gather
    never.  Returns ({name: row},
    {phase: (launches, waves)}), the phases "mv_occ", "mv_mvcc",
    "mv_mvocc" and "mv_aged"."""
    from repro_torch import kernels as K
    from repro_torch.launch.txn_bench import run_grid
    tpcc_kw = MV_KW["tpcc"] if tpcc_kw is None else tpcc_kw
    ycsb_kw = MV_KW["ycsb"] if ycsb_kw is None else ycsb_kw
    K.reset_launches()
    phases = {}

    def run(phase, *args, **kw):
        before = K.launch_counts()
        rows = run_grid(*args, mv_depth=MV_DEPTH, device=dev, **kw)
        n, w = phases.get(phase, ({op: 0 for op in before}, 0))
        phases[phase] = ({op: n[op] + c - before[op]
                          for op, c in K.launch_counts().items()},
                         w + len(rows) * waves)
        return rows
    rows = []
    for cc in ("mvcc", "mvocc"):
        rows += run(f"mv_{cc}", "tpcc", [cc], (0, 1), [lanes], waves,
                    **tpcc_kw)
    for cc in ("occ", "mvcc", "mvocc"):
        rows += run(f"mv_{cc}", "ycsb", [cc], (0, 1), [lanes], waves,
                    **ycsb_kw)
    (aged,) = run("mv_aged", "ycsb", ["mvcc"], (1,), [lanes], waves,
                  snapshot_age=8, **ycsb_kw)
    launches = {op: sum(n[op] for n, _ in phases.values())
                for op in K.WRAPPERS}
    by = {}
    for r in rows + [aged]:
        by[f"{r['workload']} {_name(r)}"] = r
        _log_row(f"{r['workload']} mv", r)
        log(f"    ro_commits {r['ro_commits']} ro_aborts {r['ro_aborts']}")
    _check_kernels("mv", rows + [aged], launches, dev, scans=False)
    for op, want in (("validate", 1), ("mv_install", 1),
                     ("claim_scatter", 0), ("mv_gather", 0)):
        per_wave = {ph: n[op] / w for ph, (n, w) in phases.items()}
        log(f"  {op} launches per wave " + json.dumps(per_wave))
        if dev.type == "cuda" and not all(
                per_wave[ph] == want
                for ph in ("mv_mvcc", "mv_mvocc", "mv_aged")):
            raise AssertionError(f"an MVCC or MV-OCC wave must launch {op} "
                                 f"{want} times: {per_wave}")
    for r in rows:
        if r["cc"] in ("mvcc", "mvocc") and r["ro_aborts"] != 0:
            raise AssertionError(f"{r['workload']} {_name(r)}: a read-only "
                                 "lane aborted under multi-versioning")
    if not by["ycsb occ-coarse"]["ro_aborts"] > 0:
        raise AssertionError("coarse OCC must abort read-only lanes on the "
                             "write-heavy YCSB mix")
    stale = aged["abort_causes"]["stale_snapshot"]
    log(f"  snapshot_age 8 (ring depth {MV_DEPTH}): {stale} stale aborts")
    if not stale > 0:
        raise AssertionError("snapshots older than the ring must abort")
    return by, phases


def unfused_path(dev, fused, waves=WAVES, lanes=LANES, **wl_kw):
    """The probe family's unfused route on TPC-C at full scale: each run
    must launch claim_probe once a wave (both claim tables in that launch
    on 2PL's and Adaptive's dual waves) and commit_install where it
    bumps, never wave_commit, and end with the fused run's results (same
    seed, same draws).  Returns ({name: row}, launches during the
    phase)."""
    from repro_torch import kernels as K
    from repro_torch.launch.txn_bench import run_grid
    K.reset_launches()
    by = {}
    for cc, gran in UNFUSED:
        before = K.launch_counts()
        (r,) = run_grid("tpcc", [cc], (gran,), [lanes], waves, device=dev,
                        fuse_wave=False, **wl_kw)
        d = {op: n - before[op] for op, n in K.launch_counts().items()}
        by[_name(r)] = r
        _log_row("tpcc unfused", r)
        bumps = cc != "tictoc"
        # One claim_probe launch a wave, on two tables where the wave is
        # dual (2PL, Adaptive).
        if dev.type == "cuda" and not (
                d["claim_probe"] == r["waves"] and d["wave_commit"] == 0
                and (d["commit_install"] > 0) == bumps):
            raise AssertionError(f"unfused {_name(r)}: launches {d}")
        ref = fused[_name(r)]
        for key in ("commits", "aborts", "abort_causes", "throughput",
                    "ext_events"):
            if r.get(key) != ref.get(key):
                raise AssertionError(f"unfused {_name(r)}: {key} "
                                     f"{r.get(key)} != fused {ref.get(key)}")
    launches = K.launch_counts()
    log(f"  unfused launches {launches}")
    return by, launches


def _draws(wl, waves, lanes, seed=5):
    """One set of draws made on the CPU: [(batch, ring tails, perm)]."""
    g = torch.Generator()
    g.manual_seed(seed)
    tails = torch.zeros((wl.n_rings,), dtype=torch.int32)
    out = []
    for w in range(waves):
        fresh, tails = wl.gen(g, w, lanes, tails)
        out.append((fresh, tails, torch.randperm(lanes, generator=g)))
    return out


def _replay(cfg, wl, draws, d, active_lanes=None, timeline=False):
    """The wave step on ``d`` over ``draws``; ``active_lanes`` < T masks
    the lanes past it as the sweep runner pads a point.  ``timeline``
    returns ``(state, the per-wave timeline's arrays)``."""
    from repro_torch.core import engine as E
    from repro_torch.core import types as t
    st = t.engine_state_init(cfg, wl.init_store(d, cfg.mv_depth,
                                                cfg.track_values))
    active = (None if active_lanes is None else
              torch.arange(cfg.lanes, device=d) < active_lanes)
    step = E.make_wave_step(cfg, active)
    tl = E.Timeline(len(draws), st.wave) if timeline else None
    for fresh, tails, perm in draws:
        fb = t.TxnBatch(**{f.name: getattr(fresh, f.name).to(d)
                           for f in dataclasses.fields(t.TxnBatch)})
        wave = st.wave
        st, row = step(st, fb, tails.to(d), perm.to(d))
        if tl is not None:
            tl.record(wave, row)
    return (st, tl.arrays()) if timeline else st


def _replay_open(cfg, wl, draws, offered, d):
    """The open-loop wave step on ``d`` over ``draws`` and the arrival
    counts ``offered``."""
    from repro_torch.core import engine as E
    from repro_torch.core import types as t
    st = t.engine_state_init(cfg, wl.init_store(d, cfg.mv_depth,
                                                cfg.track_values))
    step = E.make_open_wave_step(cfg)
    for (fresh, tl, perm), n in zip(draws, offered):
        fb = t.TxnBatch(**{f.name: getattr(fresh, f.name).to(d)
                           for f in dataclasses.fields(t.TxnBatch)})
        st, _ = step(st, fb, tl.to(d), perm.to(d), n.to(d))
    return st


INT_STATE = ("commits", "aborts", "commits_by_type", "ext_events",
             "abort_causes", "age", "pending_live", "ro_commits",
             "ro_aborts")
INT_TABLES = ("wts", "rts", "claim_w", "claim_r", "ring_tails", "pess_mode",
              "fine_mode", "heat_wave", "mv_begin", "mv_head")


def _same_state(a, b, what, rtol_time=0.0, rtol_heat=0.0):
    """Integer state bit-identical; lane_time and the heats within the
    given rtol (0: bit-identical)."""
    for name in INT_STATE:
        if not torch.equal(getattr(a, name).cpu(), getattr(b, name).cpu()):
            raise AssertionError(f"{what}: {name} differs")
    for name in INT_TABLES:
        if not torch.equal(getattr(a.store, name).cpu(),
                           getattr(b.store, name).cpu()):
            raise AssertionError(f"{what}: {name} differs")
    torch.testing.assert_close(a.lane_time.cpu(), b.lane_time.cpu(),
                               rtol=rtol_time, atol=0)
    for name in ("abort_heat", "false_heat"):
        torch.testing.assert_close(getattr(a.store, name).cpu(),
                                   getattr(b.store, name).cpu(),
                                   rtol=rtol_heat, atol=0)


def fused_unfused(dev, waves=30, scale=0.1, ccs=UNFUSED, scan_len=0):
    """The same CPU-made draws through the fused route (wave_commit) and
    the unfused route (claim_probe + commit_install) on ``dev`` must give
    the same state, bit for bit; ``scan_len`` > 0 turns TPC-C's scans on,
    which moves the fused route's bumps to commit_install."""
    from repro_torch.launch.txn_bench import make_config
    from repro_torch.workloads import TPCCWorkload
    wl = TPCCWorkload.make(n_warehouses=8, scale=scale, scan_len=scan_len)
    draws = _draws(wl, waves, LANES)
    for cc, gran in ccs:
        a, b = (_replay(make_config(wl, cc, gran, LANES, fuse), wl, draws,
                        dev) for fuse in (True, False))
        _same_state(a, b, f"fused/unfused {cc}")
        log(f"  {cc}-{'fine' if gran else 'coarse'}"
            f"{' scans' if scan_len else ''}: {waves} waves, commits "
            f"{int(a.commits)} aborts {int(a.aborts)} phantoms "
            f"{int(a.abort_causes[CAUSE_PHANTOM])}: fused = unfused on "
            f"{dev}")


def cross_device(dev, waves=30, scale=0.1, scan_len=0,
                 configs=POINT_CONFIGS):
    """The same CPU-made draws through the wave step on ``dev`` (kernels)
    and on the CPU (plain versions) must give the same state; TPC-C with
    its scans on when ``scan_len`` > 0."""
    from repro_torch.launch.txn_bench import make_config
    from repro_torch.workloads import TPCCWorkload
    wl = TPCCWorkload.make(n_warehouses=8, scale=scale, scan_len=scan_len)
    draws = _draws(wl, waves, LANES)
    cpu = torch.device("cpu")
    for cc, gran, fuse in configs:
        cfg = make_config(wl, cc, gran, LANES, fuse, mv_depth=MV_DEPTH)
        a, b = (_replay(cfg, wl, draws, d) for d in (dev, cpu))
        what = (f"{cc}-{'fine' if gran else 'coarse'}"
                + (" scans" if scan_len else "") + ("" if fuse else
                                                    " unfused"))
        _same_state(a, b, f"cross-device {what}", rtol_time=1e-5,
                    rtol_heat=1e-6)
        log(f"  {what}: {waves} waves, commits {int(a.commits)} aborts "
            f"{int(a.aborts)} ext {int(a.ext_events)} pess "
            f"{int(a.store.pess_mode.sum())} fine "
            f"{int(a.store.fine_mode.sum())} phantoms "
            f"{int(a.abort_causes[CAUSE_PHANTOM])} ring heads moved "
            f"{int((a.store.mv_head != 0).sum())}: identical on {dev} and "
            "cpu")


# ------------------------------------------------ backend op and figures
def backend_probe_path(dev, wave=9):
    """The backend ops without an engine caller on the card: ``probe`` after
    ``wave_commit`` installs one wave's write claims at the TPC-C shape
    (OCC-fine, through the backend) reads the installed table,
    ``mv_gather`` after ``mv_install`` publishes that wave's writes into a
    version ring reads the ring at the next wave's snapshot (the
    multi-version waves run its select inside their validate and claim_probe
    launches), and ``claim_scatter`` installs the next wave's write claims
    into a copy of the installed table (the waves install inside their
    validate and validate_dual launches). Counters set to 0 just before,
    read just after: one launch each. Returns the launches."""
    from repro_torch import kernels as K
    from repro_torch.core import mvstore
    from repro_torch.core.backend import BACKEND
    from repro_torch.core.claimword import NO_PRIO, inv_wave
    from repro_torch.kernels.claim_scatter import claim_scatter_plain
    from repro_torch.kernels.mv_gather import mv_gather_plain
    from repro_torch.kernels.wave_commit import probe_plain
    N, G, T, Kk = SHAPES["tpcc"]
    cw, _, wts, _ = make_tables(N, G, wave, dev, seed=31)
    keys, groups, prio, masks, _ = make_ops(N, G, T, Kk, dev, seed=31)
    do_w, _, check_w = masks[:3]
    begin, head, _ = mvstore.mv_init(N, MV_DEPTH, G, dev)
    K.reset_launches()
    _, commit = BACKEND.wave_commit(cw, None, wts, keys, groups, prio, do_w,
                                    None, check_w, None, None, None, wave,
                                    True, False, True)
    got = BACKEND.probe(cw, keys, groups, wave, True)
    BACKEND.mv_install(begin, head, keys, groups, do_w,
                       mvstore.install_ts(wave))
    snap = mvstore.snapshot_ts(wave + 1)
    slot, ok = BACKEND.mv_gather(begin, keys, groups, snap, True)
    # The next wave's write claims into a copy of the installed table.
    scattered = cw.clone()
    BACKEND.claim_scatter(scattered, keys, groups, prio, wave + 1, do_w)
    launches = K.launch_counts()
    want_table = cw.clone()
    claim_scatter_plain(want_table, keys, groups, prio, wave + 1, do_w)
    next_prio = probe_plain(scattered, keys, groups, inv_wave(wave + 1),
                            True)
    log(f"  claim_scatter of the next wave's claims: "
        f"{int((next_prio != NO_PRIO).sum())} ops see one")
    if not torch.equal(scattered, want_table):
        raise AssertionError("Backend.claim_scatter disagrees with "
                             "claim_scatter_plain")
    if bool((next_prio[do_w & (keys >= 0)] == NO_PRIO).any()):
        raise AssertionError("claim_scatter missed a claim")
    want_slot, want_ok = mv_gather_plain(begin, keys, groups, snap, True)
    fresh = do_w & (keys >= 0)
    log(f"  mv_gather of the ring after mv_install: {int(ok.sum())} ops "
        f"see a version, {int((slot[fresh] != 0).sum())} of "
        f"{int(fresh.sum())} writes their new slot")
    if not (torch.equal(slot, want_slot) and torch.equal(ok, want_ok)):
        raise AssertionError("Backend.mv_gather disagrees with "
                             "mv_gather_plain on the installed ring")
    if not bool((slot[fresh] != 0).all()):
        raise AssertionError("mv_gather missed a version mv_install "
                             "published")
    want = probe_plain(cw, keys, groups, inv_wave(wave), True)
    claimed = do_w & (keys >= 0)
    log(f"  wave_commit committed {int(commit.sum())} of {T} lanes; probe "
        f"of the installed table: {int((got != NO_PRIO).sum())} ops see a "
        f"live claimant; launches {launches}")
    if not torch.equal(got, want.to(torch.int32)):
        raise AssertionError("Backend.probe disagrees with probe_plain on "
                             "the installed table")
    if bool((got[claimed] == NO_PRIO).any()):
        raise AssertionError("probe missed a claim wave_commit installed")
    if dev.type == "cuda" and not all(
            launches[op] == 1
            for op in ("probe", "wave_commit", "mv_install", "mv_gather",
                       "claim_scatter")):
        raise AssertionError(f"backend probe: launches {launches}")
    return launches


def quickstart_path(dev):
    """examples/quickstart_torch.py's main as it ships (TPC-C 8
    warehouses, scale 0.5, T = 96, 200 waves) on ``dev``: OCC-fine must
    beat OCC-coarse and TicToc-coarse.  Returns ({name: SimResult},
    launches)."""
    import importlib.util
    from repro_torch import kernels as K
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", os.path.join(ROOT, "examples",
                                         "quickstart_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    K.reset_launches()
    res = mod.main(["--device", dev.type])
    launches = K.launch_counts()
    th = {k: r.throughput for k, r in res.items()}
    log(f"  quickstart: OCC-fine / OCC-coarse "
        f"{th['occ-fine'] / th['occ-coarse']:.4f}  OCC-fine / "
        f"TicToc-coarse {th['occ-fine'] / th['tictoc-coarse']:.4f} "
        f"(paper: 1.37x at 96 threads); launches {launches}")
    if not th["occ-fine"] > max(th["occ-coarse"], th["tictoc-coarse"]):
        raise AssertionError("quickstart: OCC-fine must beat OCC-coarse "
                             "and TicToc-coarse")
    if dev.type == "cuda" and min(launches[op] for op in MECH_OPS["tictoc"]
                                  ) <= 0:
        raise AssertionError("quickstart: a kernel never launched")
    return res, launches


#: The figures phase's grid: fig3's mechanisms of the paper's headline
#: (and MV-OCC) x coarse and fine x one lane bucket, so 64 and 96 run
#: padded to 128 under the mask.
FIG3_CCS = ("occ", "tictoc", "2pl", "mvocc")
FIG3_LANES = (64, 96, 128)


def figures_path(dev, waves=WAVES, **wl_kw):
    """fig3's grid through the benchmark CLI's grid runner (the port's
    sweep): every padded point's commits + aborts == T x waves and causes
    sum to aborts; every kernel of each mechanism launched; fig3's ratio
    lines printed, OCC-fine@96 > TicToc-coarse@96 (the paper's headline).
    Returns (rows, launches, ratios)."""
    from repro_torch import kernels as K
    from repro_torch.benchmarks.fig3_tpcc import report
    from repro_torch.launch.txn_bench import run_grid
    K.reset_launches()
    rows = run_grid("tpcc", list(FIG3_CCS), (0, 1), list(FIG3_LANES), waves,
                    mv_depth=MV_DEPTH, device=dev, **wl_kw)
    launches = K.launch_counts()
    for r in rows:
        _log_row(f"fig3 T={r['lanes']}/{r['lanes_run']}", r)
        if r["lanes_run"] != max(FIG3_LANES):
            raise AssertionError(f"{_name(r)}@{r['lanes']}: ran at "
                                 f"{r['lanes_run']} lanes")
    _check_kernels("fig3", rows, launches, dev, scans=False)
    ratios = report(rows)
    if not ratios["occ-fine@96/tictoc-coarse@96"] > 1.0:
        raise AssertionError("fig3: OCC-fine@96 must beat TicToc-coarse@96")
    return rows, launches, ratios


#: The open-loop phase's traffic: YCSB at the main path's size, arrivals
#: at 3/4 of the lane width (as benchmarks/scan_mix.py's open loop);
#: txn_bench.make_config gives the queue (4 x 128 lanes = 512 entries) and
#: the 8 incarnations.
OPEN_KW = dict(n_keys=YCSB_N, theta=0.9, write_frac=0.5, arrival_rate=96.0)


def open_loop_path(dev, waves=WAVES, lanes=LANES, **kw):
    """OCC and MVCC x coarse and fine, open-loop, through the grid runner:
    the admission identities hold exactly.  Returns (rows, launches)."""
    from repro_torch import kernels as K
    from repro_torch.launch.txn_bench import run_grid
    K.reset_launches()
    rows = run_grid("ycsb", ["occ", "mvcc"], (0, 1), [lanes], waves,
                    mv_depth=MV_DEPTH, device=dev, **{**OPEN_KW, **kw})
    launches = K.launch_counts()
    for r in rows:
        log(f"  open {_name(r):12s} goodput {r['goodput']:.4f} txn/us  "
            f"p50 {r['p50_ttc_waves']} p99 {r['p99_ttc_waves']} waves  "
            f"offered {r['offered']} admitted {r['admitted']} commits "
            f"{r['commits']} queued {r['queued_final']} inc_drops "
            f"{r['inc_drops']} arrival_drops {r['arrival_drops']} "
            f"reenq_drops {r['reenq_drops']}  {r['waves_per_s']:.1f} "
            f"waves/s  causes {r['abort_causes']}")
        if not (r["admitted"] == r["commits"] + r["queued_final"]
                + r["inc_drops"]
                and r["offered"] == r["admitted"] + r["arrival_drops"]
                and r["reenq_drops"] == 0
                and r["abort_causes"]["inc_cap"] == r["inc_drops"]
                and sum(r["abort_causes"].values()) == r["aborts"]):
            raise AssertionError(f"open loop {_name(r)}: an admission "
                                 "identity fails")
    _check_kernels("open loop", rows, launches, dev, scans=False)
    return rows, launches


#: Every mechanism the port runs (txn_bench's ``--cc`` choices).
ALL_CCS = ("occ", "tictoc", "2pl", "swisstm", "adaptive", "autogran",
           "mvcc", "mvocc")
#: Profiler and runtime event names that mean a host copy or a host wait.
HOST_WAITS = ("Memcpy HtoD", "Memcpy DtoH", "cudaStreamSynchronize",
              "cudaDeviceSynchronize")


def sync_free_configs() -> list:
    """(workload, its settings, cc, granularity, fused, arrival rate,
    tracked, values) of the sync-free phase: every mechanism x coarse and
    fine on TPC-C and YCSB point; TPC-C scan_len 200 with OCC, AutoGran
    and MVCC; YCSB-E with OCC; the unfused route with OCC, 2PL and
    Adaptive; the open step (YCSB, OCC and MVCC, rate 96, queue 512);
    tracked (``track_conflicts`` and the per-wave timeline, as
    ``engine.run`` keeps them): OCC, TicToc, AutoGran and MVCC on TPC-C
    point, OCC on TPC-C scans and MVCC open-loop; and with tracked values
    (``track_values``: the replay, and under MVCC and MV-OCC the ring's
    head copy and copy-forward): OCC, TicToc, AutoGran and MVCC on TPC-C
    point, MV-OCC on YCSB point and OCC open-loop."""
    out = [(w, MAIN_KW[w], cc, g, True, 0.0, False, False)
           for w in ("tpcc", "ycsb") for cc in ALL_CCS for g in (0, 1)]
    out += [("tpcc", SCAN_KW["tpcc"], cc, g, True, 0.0, False, False)
            for cc in ("occ", "autogran", "mvcc") for g in (0, 1)]
    out += [("ycsb", SCAN_KW["ycsb"], "occ", g, True, 0.0, False, False)
            for g in (0, 1)]
    out += [("tpcc", MAIN_KW["tpcc"], cc, g, False, 0.0, False, False)
            for cc in ("occ", "2pl", "adaptive") for g in (0, 1)]
    kw = {k: v for k, v in OPEN_KW.items() if k != "arrival_rate"}
    out += [("ycsb", kw, cc, 1, True, OPEN_KW["arrival_rate"], False, False)
            for cc in ("occ", "mvcc")]
    out += [("tpcc", MAIN_KW["tpcc"], cc, g, True, 0.0, True, False)
            for cc, g in (("occ", 1), ("tictoc", 0), ("autogran", 0),
                          ("mvcc", 1))]
    out += [("tpcc", SCAN_KW["tpcc"], "occ", 0, True, 0.0, True, False),
            ("ycsb", kw, "mvcc", 1, True, OPEN_KW["arrival_rate"], True,
             False)]
    out += [("tpcc", MAIN_KW["tpcc"], cc, g, True, 0.0, False, True)
            for cc, g in (("occ", 1), ("tictoc", 0), ("autogran", 0),
                          ("mvcc", 1))]
    out += [("ycsb", MAIN_KW["ycsb"], "mvocc", 0, True, 0.0, False, True),
            ("ycsb", kw, "occ", 1, True, OPEN_KW["arrival_rate"], False,
             True)]
    return out


def sync_free_path(dev, warm=2, waves=3, lanes=LANES, configs=None):
    """The gate of a capturable wave: for each configuration
    (``sync_free_configs``) two eager waves of ``engine.draw_wave`` (the
    draws and the step, as ``run_waves`` makes them), then ``waves`` more
    under ``torch.cuda.set_sync_debug_mode("error")`` (any synchronizing
    call raises) and ``torch.profiler``, which must show no ``HOST_WAITS``
    event inside them (the mode does not flag a copy from pageable
    memory).  A tracked configuration also records every wave's row into
    a per-wave ``Timeline``, inside the guarded waves; a configuration
    with values tracks them (its waves replay into them, and must change
    them).  The wave index
    must have advanced on the device and every lane of every wave must
    commit or abort.  Returns (launches during the profiled waves, waves
    profiled)."""
    from torch.autograd import DeviceType
    from repro_torch import kernels as K
    from repro_torch.core.engine import (Timeline, arrival_rate, draw_wave,
                                         make_open_wave_step, make_wave_step)
    from repro_torch.core.types import engine_state_init
    from repro_torch.launch.txn_bench import make_config, make_workload
    from repro_torch.launch.wave_profile import device_ops
    configs = sync_free_configs() if configs is None else configs
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    workloads = {}
    launches = {op: 0 for op in K.WRAPPERS}
    for wl_name, wl_kw, cc, gran, fuse, rate, track, values in configs:
        key = (wl_name, tuple(sorted(wl_kw.items())))
        if key not in workloads:
            workloads[key] = make_workload(wl_name, **wl_kw)
        wl = workloads[key]
        cfg = dataclasses.replace(
            make_config(wl, cc, gran, lanes, fuse, mv_depth=MV_DEPTH,
                        arrival_rate=rate, track_values=values),
            track_conflicts=track)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        state = engine_state_init(cfg, wl.init_store(dev, cfg.mv_depth,
                                                     values))
        step = (make_open_wave_step if cfg.open_loop else make_wave_step)(
            cfg)
        r = arrival_rate(cfg, dev)
        for _ in range(warm):
            state, _ = draw_wave(cfg, wl, state, step, gen, r)
        timeline = Timeline(waves, state.wave) if track else None
        _sync(dev)
        before = K.launch_counts()
        with torch.profiler.profile(activities=acts) as prof:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode("error")
            try:
                with torch.profiler.record_function("repro:sync_free_waves"):
                    for _ in range(waves):
                        wave = state.wave
                        state, row = draw_wave(cfg, wl, state, step, gen, r)
                        if track:
                            timeline.record(wave, row)
            finally:
                if dev.type == "cuda":
                    torch.cuda.set_sync_debug_mode(0)
            _sync(dev)
        for op, n in K.launch_counts().items():
            launches[op] += n - before[op]
        events = prof.events()
        (span,) = [e for e in events if e.name == "repro:sync_free_waves"
                   and e.device_type == DeviceType.CPU]
        lo, hi = span.time_range.start, span.time_range.end
        inside = [e for e in events if e.device_type == DeviceType.CUDA
                  or lo <= e.time_range.start <= hi]
        waits = [e.name for e in inside
                 if any(w in e.name for w in HOST_WAITS)]
        n_dev = len(device_ops(events)[0])
        what = (f"{wl_name}{' scans' if wl.max_extent > 1 else ''} "
                f"{cc}-{'fine' if gran else 'coarse'}"
                f"{'' if fuse else ' unfused'}"
                f"{f' open rate {rate:g}' if rate else ''}"
                f"{' tracked' if track else ''}"
                f"{' values' if values else ''}")
        log(f"  sync-free {what}: {waves} waves, {len(waits)} host copies "
            f"and syncs, {n_dev / waves:.1f} device events a wave")
        if waits:
            raise AssertionError(f"sync-free {what}: host waits {waits}")
        if int(state.wave) != warm + waves:
            raise AssertionError(f"sync-free {what}: wave {int(state.wave)}")
        done = int(state.commits + state.aborts)
        if not cfg.open_loop and done != lanes * (warm + waves):
            raise AssertionError(f"sync-free {what}: {done} lanes done")
        if track:
            rows = timeline.arrays()
            lanes_done = rows["per_wave_commits"] + rows["per_wave_aborts"]
            if not cfg.open_loop and (lanes_done != lanes).any():
                raise AssertionError(f"sync-free {what}: timeline "
                                     f"{lanes_done.tolist()}")
        if dev.type == "cuda" and n_dev == 0:
            raise AssertionError(f"sync-free {what}: nothing ran on the "
                                 "device")
        if values and not bool(state.store.values.any()):
            raise AssertionError(f"sync-free {what}: no value written")
    log(f"  sync-free launches {launches}")
    return launches, len(configs) * waves


def cross_device_padded(dev, waves=30, scale=0.1, active_lanes=96,
                        configs=(("occ", 1), ("tictoc", 0), ("mvocc", 1))):
    """One point below its bucket maximum (``active_lanes`` of LANES) from
    CPU-made draws through the masked wave step on ``dev`` and on the CPU:
    integer state bit-identical, lane_time within rtol 1e-5; padding
    lanes never count."""
    from repro_torch.launch.txn_bench import make_config
    from repro_torch.workloads import TPCCWorkload
    wl = TPCCWorkload.make(n_warehouses=8, scale=scale)
    draws = _draws(wl, waves, LANES)
    cpu = torch.device("cpu")
    for cc, gran in configs:
        cfg = make_config(wl, cc, gran, LANES, mv_depth=MV_DEPTH)
        a, b = (_replay(cfg, wl, draws, d, active_lanes) for d in (dev, cpu))
        what = f"{cc}-{'fine' if gran else 'coarse'} T={active_lanes}"
        _same_state(a, b, f"cross-device padded {what}", rtol_time=1e-5,
                    rtol_heat=1e-6)
        if int(a.commits + a.aborts) != active_lanes * waves:
            raise AssertionError(f"{what}: padding lanes counted")
        log(f"  {what} of {LANES}: {waves} waves, commits {int(a.commits)} "
            f"aborts {int(a.aborts)}: identical on {dev} and cpu")


def cross_device_open(dev, waves=30, n_keys=100_000, configs=(("mvcc", 1),)):
    """One open-loop configuration from CPU-made draws and arrival counts
    through the open step on ``dev`` and on the CPU: integer state, the
    admission counters, the histogram and the queue bit-identical."""
    from repro_torch.launch.txn_bench import make_config, make_workload
    from repro_torch.workloads.arrivals import poisson_offered
    rate = OPEN_KW["arrival_rate"]
    wl = make_workload("ycsb", n_keys=n_keys, theta=0.9)
    draws = _draws(wl, waves, LANES)
    g = torch.Generator()
    g.manual_seed(6)
    offered = [poisson_offered(g, rate, LANES) for _ in range(waves)]
    cpu = torch.device("cpu")
    for cc, gran in configs:
        cfg = make_config(wl, cc, gran, LANES, mv_depth=MV_DEPTH,
                          arrival_rate=rate)
        a, b = (_replay_open(cfg, wl, draws, offered, d) for d in (dev, cpu))
        what = f"open {cc}-{'fine' if gran else 'coarse'}"
        _same_state(a, b, f"cross-device {what}", rtol_time=1e-5,
                    rtol_heat=1e-6)
        for name in ("next_id", "offered", "admitted", "arrival_drops",
                     "inc_drops", "reenq_drops", "lat_hist"):
            if not torch.equal(getattr(a.ol, name).cpu(),
                               getattr(b.ol, name).cpu()):
                raise AssertionError(f"cross-device {what}: {name} differs")
        for f in dataclasses.fields(a.ol.queue):
            if not torch.equal(getattr(a.ol.queue, f.name).cpu(),
                               getattr(b.ol.queue, f.name).cpu()):
                raise AssertionError(f"cross-device {what}: queue "
                                     f"{f.name} differs")
        log(f"  {what} (queue {cfg.queue_cap}, {cfg.max_incarnations} "
            f"incarnations): {waves} waves, offered {int(a.ol.offered)} "
            f"commits {int(a.commits)} queued {int(a.ol.queue.size)} inc_drops "
            f"{int(a.ol.inc_drops)}: identical on {dev} and cpu")


# ------------------------------------------------------------ observability
#: The observability phase's tracked mechanisms at full width: the
#: cross-device pair (OCC fine, TicToc coarse), MVCC and AutoGran.
OBS_CONFIGS = (("occ", 1), ("tictoc", 0), ("mvcc", 0), ("autogran", 0))
#: The launches a tracked wave adds: the conflict histogram's +1 scatter,
#: same-cell count and peak install.
TRACK_OPS = {"commit_install": 1, "segment_count": 1, "ts_install_max": 1}
PER_WAVE_INT = ("per_wave_commits", "per_wave_aborts", "per_wave_causes")


def _same_timeline(a: dict, b: dict, what: str, rtol: float = 0.0):
    """Per-wave integer series bit-identical, simulated µs within
    ``rtol``."""
    import numpy as np
    for k in PER_WAVE_INT:
        if not np.array_equal(a[k], b[k]):
            raise AssertionError(f"{what}: {k} differs")
    np.testing.assert_allclose(a["per_wave_us"], b["per_wave_us"], rtol=rtol,
                               atol=0, err_msg=f"{what}: per_wave_us")


def observability_path(dev, waves=WAVES, lanes=LANES, scale=1.0,
                       out_dir=None):
    """The conflict histogram and the per-wave timeline at full width
    (TPC-C 8 warehouses at ``scale``, T = ``lanes``): each of
    ``OBS_CONFIGS`` through ``engine.run`` with ``track_conflicts`` off
    and on, same seed: the runs identical (every state field but the
    conflict tables, and the per-wave series), the tracked run launching
    exactly ``TRACK_OPS`` more a wave and finding hot records.  Then the
    benchmark CLI with ``--trace`` (OCC and TicToc, coarse and fine): the
    Chrome trace written under ``out_dir`` (default build/observability)
    and valid, one slice a wave, and every row carrying the cost-model
    columns of analysis/txn_cost.py.  Returns (launches, waves driven)."""
    from repro_torch import kernels as K
    from repro_torch.analysis.trace import validate_chrome_trace
    from repro_torch.core import engine as E
    from repro_torch.launch import txn_bench
    wl = txn_bench.make_workload("tpcc", scale=scale)
    K.reset_launches()
    n_waves = 0
    for cc, gran in OBS_CONFIGS:
        res, delta = {}, {}
        for track in (False, True):
            cfg = dataclasses.replace(
                txn_bench.make_config(wl, cc, gran, lanes,
                                      mv_depth=MV_DEPTH),
                track_conflicts=track)
            before = K.launch_counts()
            res[track] = E.run(cfg, wl, waves, seed=7, device=dev,
                               keep_state=True)
            delta[track] = {op: n - before[op]
                            for op, n in K.launch_counts().items()}
            n_waves += waves
        off, on = res[False], res[True]
        what = f"tracking {cc}-{'fine' if gran else 'coarse'}"
        _same_state(off.final_state, on.final_state, what)
        _same_timeline(vars(off), vars(on), what)
        added = {op: (delta[True][op] - delta[False][op]) / waves
                 for op in delta[True]}
        want = {op: TRACK_OPS.get(op, 0) if dev.type == "cuda" else 0
                for op in added}
        hits = int(on.final_state.conflict_hits.sum())
        log(f"  {what}: {waves} waves, commits {on.commits} aborts "
            f"{on.aborts}, {hits} conflicting ops, hot records "
            f"{on.hot_records[:4]}; launches a wave added "
            + json.dumps({op: n for op, n in added.items() if n})
            + "; tracking off = on")
        if added != want:
            raise AssertionError(f"{what}: launches a wave added {added}")
        if not (on.hot_records and off.hot_records is None
                and on.per_wave_commits.shape == (waves,)):
            raise AssertionError(f"{what}: no hot records or timeline")
    out_dir = out_dir or os.path.join(ROOT, "build", "observability")
    os.makedirs(out_dir, exist_ok=True)
    trace = os.path.join(out_dir, "txn_trace.json")
    rows = txn_bench.main([
        "--workload", "tpcc", "--scale", str(scale), "--cc", "occ",
        "tictoc", "--lanes", str(lanes), "--waves", str(waves), "--device",
        dev.type, "--trace", trace,
        "--json", os.path.join(out_dir, "rows.json")])
    n_waves += len(rows) * waves
    with open(trace) as f:
        doc = json.load(f)
    errs = validate_chrome_trace(doc)
    slices = sum(e["ph"] == "X" for e in doc["traceEvents"])
    log(f"  trace {trace}: {len(doc['traceEvents'])} events, {slices} "
        f"wave slices, {len(errs)} schema errors, "
        f"{os.path.getsize(trace)} bytes")
    if errs or slices != len(rows) * waves:
        raise AssertionError(f"trace: {errs[:3]}, {slices} slices")
    for r in rows:
        want = txn_bench._cost_fields(r["cc"], r["lanes"], r["granularity"],
                                      wl.slots, wl.n_groups, 0)
        got = {k: r.get(k) for k in want}
        log(f"  txn_bench row {_name(r)}: " + json.dumps(got))
        if got != want:
            raise AssertionError(f"{_name(r)}: cost columns {got}")
    return K.launch_counts(), n_waves


def cross_device_observability(dev, waves=30, scale=0.1,
                               configs=(("occ", 1), ("tictoc", 0))):
    """Tracked runs of CPU-made draws through the wave step on ``dev`` and
    on the CPU, the per-wave timeline kept: the conflict tables and
    ``hot_records`` bit-identical, the per-wave integer series too and the
    simulated µs within rtol 1e-5 (as the rest of the state)."""
    from repro_torch.core.engine import hot_records
    from repro_torch.launch.txn_bench import make_config
    from repro_torch.workloads import TPCCWorkload
    wl = TPCCWorkload.make(n_warehouses=8, scale=scale)
    draws = _draws(wl, waves, LANES)
    cpu = torch.device("cpu")
    for cc, gran in configs:
        cfg = dataclasses.replace(
            make_config(wl, cc, gran, LANES, mv_depth=MV_DEPTH),
            track_conflicts=True)
        (a, ta), (b, tb) = (_replay(cfg, wl, draws, d, timeline=True)
                            for d in (dev, cpu))
        what = f"cross-device tracking {cc}-{'fine' if gran else 'coarse'}"
        _same_state(a, b, what, rtol_time=1e-5, rtol_heat=1e-6)
        for name in ("conflict_hits", "conflict_peak"):
            if not torch.equal(getattr(a, name).cpu(), getattr(b, name)):
                raise AssertionError(f"{what}: {name} differs")
        hot = hot_records(a)
        if hot != hot_records(b) or not hot:
            raise AssertionError(f"{what}: hot records differ or are empty")
        _same_timeline(ta, tb, what, rtol=1e-5)
        log(f"  {what}: {waves} waves, commits {int(a.commits)}, hot "
            f"records {hot[:3]}, per-wave commits "
            f"{ta['per_wave_commits'][:6].tolist()}...: identical on {dev} "
            "and cpu")


# ----------------------------------------------------------- tracked values
#: The values phase's sources, at the main path's full sizes, and its
#: mechanisms (cc, granularity).
VALUE_SOURCES = {"tpcc": MAIN_KW["tpcc"], "ycsb": MAIN_KW["ycsb"]}
VALUE_CONFIGS = (("occ", 1), ("tictoc", 0), ("2pl", 1), ("autogran", 0),
                 ("mvcc", 0), ("mvocc", 1))
#: Snapshot ages the MV runs read at after every wave: the wave's own
#: snapshot, up to three waves back (the ring holds MV_DEPTH versions)
#: and five back, where a hot record's version can be reclaimed.
SNAPSHOT_AGES = (0, 1, 2, 3, 5)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _values_run(cfg, wl, dev, waves, ages=()):
    """``waves`` waves of ``draw_wave`` from a fresh store (seed 0); with
    ``ages`` (a tracked MV run), after wave w each op of wave w - a reads
    its cell at that wave's snapshot (ts = w - a + 1) through
    ``mvstore.snapshot_values``, and a read that is ``ok`` must equal the
    flat value recorded after wave w - a, bit for bit.  Returns (state,
    host seconds, ok reads, reclaimed reads)."""
    from repro_torch.core import mvstore
    from repro_torch.core.claims import record_index
    from repro_torch.core.engine import draw_wave, make_wave_step
    from repro_torch.core.types import engine_state_init
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = engine_state_init(cfg, wl.init_store(dev, cfg.mv_depth,
                                                 cfg.track_values))
    step = make_wave_step(cfg)
    hist, n_ok, n_stale = [], 0, 0
    _sync(dev)
    t0 = time.perf_counter()
    for w in range(waves):
        state, _ = draw_wave(cfg, wl, state, step, gen)
        if not ages:
            continue
        st, b = state.store, state.pending
        k, valid = record_index(b.op_key, st.n_records)
        c, cvalid = record_index(b.op_col, st.values.shape[1])
        hist.append((b.op_key, b.op_group, b.op_col, valid & cvalid,
                     st.values[k, c]))
        hist = hist[-(max(ages) + 1):]
        for a in ages:
            if a >= len(hist):
                continue
            keys, groups, cols, live, want = hist[-1 - a]
            got, ok = mvstore.snapshot_values(
                st.mv_vals, st.mv_begin, keys, groups, cols, w - a + 1,
                cfg.granularity == 1)
            if not torch.equal(_bits(got[ok]), _bits(want[ok])):
                raise AssertionError(f"snapshot read of wave {w - a} at "
                                     f"wave {w}: a value differs")
            n_ok += int(ok.sum())
            n_stale += int((live & ~ok).sum())
    _sync(dev)
    return state, time.perf_counter() - t0, n_ok, n_stale


def values_path(dev, waves=WAVES, lanes=LANES, sources=VALUE_SOURCES,
                configs=VALUE_CONFIGS, ages=SNAPSHOT_AGES):
    """Tracked values at full width: each of ``configs`` on each source
    (TPC-C 8 warehouses at scale 1.0, YCSB 10M) run untracked and tracked
    from the same seed.  The two runs' commits, counters and every table
    are identical; the tracked run launches apply_values once a wave
    (twice under MVCC and MV-OCC: the flat values and the ring) and
    nothing else more; on TPC-C each warehouse's and district's YTD sums
    to the committed payments exactly (each payment adds 1.0 to both);
    under MVCC and MV-OCC the ring's newest versions equal the flat
    values, and the snapshot reads of ``_values_run`` agree with the flat
    values of the wave they snapshot.  The counters are set to 0 just
    before each run and read just after.  Returns (launches over the
    tracked runs, tracked waves)."""
    from repro_torch import kernels as K
    from repro_torch.launch.txn_bench import make_config, make_workload
    from repro_torch.workloads import tpcc as T
    total = {op: 0 for op in K.WRAPPERS}
    for src, kw in sources.items():
        wl = make_workload(src, **kw)
        for cc, gran in configs:
            cfg = make_config(wl, cc, gran, lanes, mv_depth=MV_DEPTH)
            mv = cfg.mv_depth > 0
            what = f"{src} {cc}-{'fine' if gran else 'coarse'}"
            K.reset_launches()
            plain, secs_p, _, _ = _values_run(cfg, wl, dev, waves)
            base = K.launch_counts()
            K.reset_launches()
            tracked, secs_t, n_ok, n_stale = _values_run(
                dataclasses.replace(cfg, track_values=True), wl, dev, waves,
                ages if mv else ())
            launched = K.launch_counts()
            for op in total:
                total[op] += launched[op]
            _same_state(plain, tracked, f"values {what}")
            extra = {op: n - base[op] for op, n in launched.items()
                     if n != base[op]}
            want = {"apply_values": waves * (2 if mv else 1)}
            if mv:
                want["mv_gather"] = sum(
                    sum(a <= w for a in ages) for w in range(waves))
            st = tracked.store
            line = (f"  {what}: commits {int(tracked.commits)} = untracked, "
                    f"tables identical; {waves / secs_p:.1f} waves/s "
                    f"untracked, {waves / secs_t:.1f} tracked; launches "
                    f"added {extra}")
            if mv:
                line += f"; snapshot reads ok {n_ok}, reclaimed {n_stale}"
            if src == "tpcc":
                pay = int(tracked.commits_by_type[T.PAYMENT])
                w_ytd = st.values[:wl.n_warehouses, T.W_YTD].double().sum()
                d_ytd = st.values[wl.d_base:wl.d_base + wl.n_dist_total,
                                  T.D_YTD].double().sum()
                line += (f"; payments {pay}, W_YTD sum {float(w_ytd)}, "
                         f"D_YTD sum {float(d_ytd)}")
                if not float(w_ytd) == float(d_ytd) == pay > 0:
                    raise AssertionError(f"values {what}: YTD sums "
                                         f"{float(w_ytd)}, {float(d_ytd)} "
                                         f"!= {pay} payments")
            log(line)
            if dev.type == "cuda" and extra != want:
                raise AssertionError(f"values {what}: launches added "
                                     f"{extra}, want {want}")
            if not bool(st.values.any()):
                raise AssertionError(f"values {what}: no value written")
            if mv:
                newest = st.mv_vals[torch.arange(st.n_records, device=dev),
                                    st.mv_head.long()]
                if not torch.equal(_bits(newest), _bits(st.values)):
                    raise AssertionError(f"values {what}: the ring's newest "
                                         "versions differ from the values")
                if n_ok == 0:
                    raise AssertionError(f"values {what}: no snapshot read "
                                         "was ok")
            del plain, tracked, st
    log(f"  values launches {total}")
    return total, len(sources) * len(configs) * waves


def cross_device_values(dev, waves=30, scale=0.1,
                        configs=(("occ", 1), ("tictoc", 0), ("mvcc", 0),
                                 ("mvocc", 1))):
    """Tracked runs of CPU-made draws through the wave step on ``dev``
    (the apply_values kernel) and on the CPU (the plain replay): the
    values and the ring's values bit-identical, the rest of the state as
    ``cross_device``."""
    from repro_torch.launch.txn_bench import make_config
    from repro_torch.workloads import TPCCWorkload
    wl = TPCCWorkload.make(n_warehouses=8, scale=scale)
    draws = _draws(wl, waves, LANES)
    cpu = torch.device("cpu")
    for cc, gran in configs:
        cfg = make_config(wl, cc, gran, LANES, mv_depth=MV_DEPTH,
                          track_values=True)
        a, b = (_replay(cfg, wl, draws, d) for d in (dev, cpu))
        what = f"cross-device values {cc}-{'fine' if gran else 'coarse'}"
        _same_state(a, b, what, rtol_time=1e-5, rtol_heat=1e-6)
        for name in ("values", "mv_vals"):
            if not torch.equal(_bits(getattr(a.store, name).cpu()),
                               _bits(getattr(b.store, name))):
                raise AssertionError(f"{what}: {name} differs")
        log(f"  {what}: {waves} waves, commits {int(a.commits)}, "
            f"{int((a.store.values != 0).sum())} cells written, values "
            f"and ring values identical on {dev} and cpu")


# ------------------------------------------------------------ sharded path
#: The sharded phase's sources: the main path's YCSB and TPC-C and YCSB
#: workload E, at their own sizes.
DIST_SOURCES = {
    "ycsb": ("ycsb", dict(n_keys=YCSB_N, theta=0.9, write_frac=0.5)),
    "tpcc": ("tpcc", dict(scale=1.0)),
    "ycsb_e": ("ycsb", dict(n_keys=YCSB_N, theta=0.9, **{
        k: v for k, v in SCAN_KW["ycsb"].items() if k.startswith("scan")})),
}
#: (cc, granularity, fused) per source: OCC, MVCC and MV-OCC at both
#: granularities and OCC fine unfused on the point mixes; OCC and MV-OCC
#: fine on workload E.
_DIST_POINT = (("occ", 0, True), ("occ", 1, True), ("mvcc", 0, True),
               ("mvcc", 1, True), ("mvocc", 0, True), ("mvocc", 1, True),
               ("occ", 1, False))
DIST_CONFIGS = {"ycsb": _DIST_POINT, "tpcc": _DIST_POINT,
                "ycsb_e": (("occ", 1, True), ("mvocc", 1, True))}
#: The card = CPU check's reduced sources and configurations.
DIST_CROSS_SOURCES = {
    "ycsb": ("ycsb", dict(n_keys=100_000, theta=0.9, write_frac=0.5)),
    "tpcc": ("tpcc", dict(scale=0.05)),
    "ycsb_e": ("ycsb", dict(n_keys=100_000, theta=0.9, scan_frac=0.95,
                            scan_len=100)),
}
DIST_CROSS_CONFIGS = {
    "ycsb": (("occ", 0, True), ("occ", 1, False), ("mvcc", 1, True),
             ("mvocc", 0, True)),
    "tpcc": (("occ", 1, True), ("mvcc", 0, True), ("mvocc", 1, True)),
    "ycsb_e": (("occ", 0, True), ("mvcc", 1, True), ("mvocc", 1, True)),
}


def dist_config(wl, cc, gran, fuse, lanes):
    from repro_torch.core.distributed import DistConfig
    return DistConfig(n_records=wl.n_records, n_groups=wl.n_groups,
                      lanes_per_shard=lanes, slots=wl.slots,
                      granularity=gran, cc=cc,
                      mv_depth=MV_DEPTH if cc != "occ" else 0,
                      max_extent=wl.max_extent, fuse_wave=fuse)


def dist_draws(wl, waves, lanes, dev, seed=13):
    """``waves`` fresh batches from the workload's generator on ``dev``, each
    with a lane permutation as its prio: ([(batch, prio)], the stacked
    wire inputs (keys, groups, kinds, prio)); kinds pack each op's extent
    (``kind | extent << 2``) when the workload scans."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    tails = torch.zeros((wl.n_rings,), dtype=torch.int32, device=dev)
    out = []
    for w in range(waves):
        b, tails = wl.gen(g, w, lanes, tails)
        out.append((b, torch.randperm(lanes, generator=g, device=dev).to(
            torch.int32)))
    kinds = [b.op_kind | (b.op_extent << 2) if wl.max_extent > 1
             else b.op_kind for b, _ in out]
    return out, (torch.stack([b.op_key for b, _ in out]),
                 torch.stack([b.op_group for b, _ in out]),
                 torch.stack(kinds), torch.stack([p for _, p in out]))


def run_sharded(cfg, group, stacked, dev, pipelined=False, mesh_shape=None):
    """One run of the sharded engine over the stacked draws on fresh
    tables: (commit [waves, T], tables, stats [waves, STATS_LEN], host
    seconds, the run's ``Exchange``).  ``pipelined`` forces the software
    pipeline (``_pipelined_run``) whatever the shard count."""
    from repro_torch.core import distributed as D
    waves = stacked[0].shape[0]
    tables = D.init_tables(cfg, group, dev)
    make = D._pipelined_run if pipelined else D.make_run_fn
    run = make(cfg, waves, group, mesh_shape)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    commit, tables, stats = run(*stacked, tables)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (commit, tables, stats, time.perf_counter() - t0, run.exchange)


def local_replay(wl, cc, gran, lanes, draws, dev):
    """The local validator of ``cc`` on the same draws and prio, without
    window thinning: (commit [waves, T], its tables in the sharded
    engine's order)."""
    from repro_torch.core import types as t
    from repro_torch.core.cc import VALIDATORS
    from repro_torch.launch.txn_bench import make_config
    cfg = dataclasses.replace(
        make_config(wl, cc, gran, lanes, mv_depth=MV_DEPTH),
        cost=t.CostModel(opt_overlap=1.0, phase_overlap=1.0))
    store = t.store_init(wl.n_records, wl.n_groups, wl.n_rings, device=dev,
                         mv_depth=cfg.mv_depth)
    commits = []
    for w, (batch, prio) in enumerate(draws):
        store, res = VALIDATORS[cfg.cc](store, batch, prio, w, cfg)
        commits.append(res.commit)
    tables = ((store.claim_w, store.claim_r, store.mv_begin, store.mv_head)
              if cfg.cc in t.MV_CCS else (store.wts, store.claim_w))
    return torch.stack(commits), tables


def _same_run(a, b, what):
    """Commit masks, tables and stats (where both have them)
    bit-identical."""
    for name, x, y in (("commit", a[0], b[0]), ("stats", a[2], b[2])):
        if x is not None and y is not None and not torch.equal(x.cpu(),
                                                               y.cpu()):
            raise AssertionError(f"{what}: {name} differs")
    for i, (x, y) in enumerate(zip(a[1], b[1])):
        if not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f"{what}: table {i} differs")


def _profile_run(cfg, group, stacked, dev, n=20, pipelined=False):
    """Device events, busy ms, idle share and top kernels per wave over
    ``n`` waves (the card only; a pipelined run's three drain steps
    counted in its waves')."""
    if dev.type != "cuda":
        return {}
    from repro_torch.launch.wave_profile import profile_device
    head = tuple(x[:n] for x in stacked)
    r = profile_device(lambda: run_sharded(cfg, group, head, dev,
                                           pipelined), n)
    return {k: r[k] for k in ("device_events_per_wave",
                              "device_busy_ms_per_wave",
                              "device_idle_share", "top_device")}


def sharded_path(dev, group=None, waves=WAVES, lanes=DIST_LANES,
                 sources=DIST_SOURCES, configs=DIST_CONFIGS, keep=None):
    """The sharded engine (core/distributed.make_run_fn) on ``group``'s
    shards over the port's generators: every configuration's kernels
    launch ("cuda" for every op, iterate_validate only with scans), the
    causes sum to the aborts, MVCC sees no phantom and MVCC/MV-OCC abort
    no read-only lane; at one shard each run commits exactly the lanes the
    local validator commits, with the same tables; fused = unfused.  The
    launch counters are set to 0 just before each run and read just
    after.  Returns ({name: row}, launches over the runs, runs); with a
    dict ``keep``, each source's stacked draws and each run's (commit,
    tables, stats) stay in it by name."""
    from repro_torch import kernels as K
    from repro_torch.core import distributed as D
    from repro_torch.core import types as t
    from repro_torch.core.backend import dist_kernel_coverage
    from repro_torch.launch.txn_bench import make_workload
    ns = D.n_shards(group)
    total = {op: 0 for op in K.WRAPPERS}
    by, path_ops = {}, set()
    for src, (kind, kw) in sources.items():
        wl = make_workload(kind, **kw)
        draws, stacked = dist_draws(wl, waves, lanes, dev)
        if keep is not None:
            keep[src] = stacked
        fused = {}
        # A short run first, so that no configuration's pace pays for the
        # first use of the collective and the kernels.
        run_sharded(dist_config(wl, *configs[src][0], lanes), group,
                    tuple(x[:3] for x in stacked), dev)
        for cc, gran, fuse in configs[src]:
            cfg = dist_config(wl, cc, gran, fuse, lanes)
            name = (f"{src} {cc}-{'fine' if gran else 'coarse'}"
                    + ("" if fuse else " unfused"))
            K.reset_launches()
            out = run_sharded(cfg, group, stacked, dev)
            launches, calls = K.launch_counts(), K.call_counts()
            for op in total:
                total[op] += launches[op]
            commit, tables, stats, secs, exchange = out
            sent = exchange.bytes_sent
            if keep is not None:
                keep[name] = out[:3]
            s = stats.to(torch.int64).sum(dim=0).cpu().tolist()
            cov = dist_kernel_coverage(cc, launches, calls, fuse)
            scans = cfg.max_extent > 1
            want = {op: ("not_run" if op == "iterate_validate" and not scans
                         else "cuda" if dev.type == "cuda" else "torch")
                    for op in cov}
            row = {"commits": s[D.STAT_COMMITS], "aborts": s[D.STAT_ABORTS],
                   "ro_commits": s[D.STAT_RO_COMMITS],
                   "ro_aborts": s[D.STAT_RO_ABORTS],
                   "dropped_ops": s[D.STAT_DROPPED_OPS],
                   "abort_causes": {t.CAUSE_NAMES[i]: n for i, n in
                                    enumerate(s[D.STAT_CAUSES])},
                   "waves_per_s": waves / secs,
                   "coll_bytes_per_wave": sent / waves,
                   "wire_bytes_per_wave": D.wire_bytes_per_wave(
                       cfg, ns)["wire_bytes_per_wave"],
                   "cap": cfg.cap(ns), "kernel_ops": cov,
                   **_profile_run(cfg, group, stacked, dev)}
            by[name] = row
            log(f"  {name:24s} commits {row['commits']:6d} aborts "
                f"{row['aborts']:6d} ro {row['ro_commits']}/"
                f"{row['ro_aborts']}  {row['waves_per_s']:.1f} waves/s  "
                f"coll {row['coll_bytes_per_wave']:.0f} B/wave  device ops/"
                f"wave {row.get('device_events_per_wave', 'not measured')}"
                f"  busy ms/wave "
                f"{row.get('device_busy_ms_per_wave', 'not measured')}"
                f"  idle {row.get('device_idle_share', 'not measured')}  "
                f"causes {row['abort_causes']}  kernels {cov}  top "
                f"{row.get('top_device', [])[:3]}")
            path_ops |= {op for op, v in want.items() if v != "not_run"}
            if cov != want:                                        # (a)
                raise AssertionError(f"sharded {name}: kernel_ops {cov} != "
                                     f"{want}")
            # One claim_probe call a wave: both claim channels and the
            # ring read of an MV wave, the writer table of an unfused OCC
            # wave; no mv_gather.
            if "claim_probe" in cov and (
                    calls["claim_probe"] != waves or dev.type == "cuda"
                    and launches["claim_probe"] != waves):
                raise AssertionError(f"sharded {name}: claim_probe calls "
                                     f"{calls['claim_probe']}, launches "
                                     f"{launches['claim_probe']} over "
                                     f"{waves} waves")
            if calls["mv_gather"]:
                raise AssertionError(f"sharded {name}: mv_gather called "
                                     f"{calls['mv_gather']} times")
            # The sender packs and unpacks once a wave each; the owner's
            # claim launch writes the verdict words and its install launch
            # reads the commit words, one launch a wave each.
            once = ("verdict_pack", "verdict_unpack",
                    "claim_probe" if "claim_probe" in cov else "wave_commit",
                    "mv_install" if cfg.is_mv else "commit_install")
            for op in once:
                if calls[op] != waves or (dev.type == "cuda"
                                          and launches[op] != waves):
                    raise AssertionError(
                        f"sharded {name}: {op} calls {calls[op]}, "
                        f"launches {launches[op]} over {waves} waves "
                        "(one a wave)")
            if sum(s[D.STAT_CAUSES]) != s[D.STAT_ABORTS]:          # (e)
                raise AssertionError(f"sharded {name}: causes do not sum "
                                     "to aborts")
            if s[D.STAT_COMMITS] + s[D.STAT_ABORTS] != lanes * ns * waves:
                raise AssertionError(f"sharded {name}: commits + aborts != "
                                     "lanes x waves")
            if cc == "mvcc" and s[D.STAT_CAUSE0 + CAUSE_PHANTOM]:
                raise AssertionError(f"sharded {name}: MVCC saw a phantom")
            if cc != "occ" and s[D.STAT_RO_ABORTS]:
                raise AssertionError(f"sharded {name}: a read-only lane "
                                     "aborted under multi-versioning")
            if row["coll_bytes_per_wave"] != row["wire_bytes_per_wave"]:
                raise AssertionError(f"sharded {name}: collective bytes "
                                     "differ from the wire model")
            if ns == 1:                                            # (b)
                lc, lt = local_replay(wl, cc, gran, lanes, draws, dev)
                _same_run((commit, tables, None), (lc, lt, None),
                          f"sharded {name} vs the local validator")
            if cc == "occ" and gran == 1:
                fused[fuse] = out[:3]
        if len(fused) == 2:                                        # (d)
            _same_run(fused[True], fused[False], f"{src} fused/unfused")
            log(f"  {src}: OCC fine fused = unfused")
        if ns == 1:
            log(f"  {src}: one shard = the local validator in every "
                "configuration")
    log(f"  sharded launches {total}")
    if dev.type == "cuda" and min(total[op] for op in path_ops) <= 0:
        raise AssertionError("sharded path: a kernel never launched")
    return by, total, sum(len(c) for c in configs.values())


def sharded_cross_device(dev, group=None, cpu_group=None, waves=30,
                         lanes=DIST_LANES, sources=DIST_CROSS_SOURCES,
                         configs=DIST_CROSS_CONFIGS):
    """The same CPU-made draws through the sharded engine on ``dev`` (the
    kernels, over ``group``) and on the CPU (the plain versions, over the
    gloo ``cpu_group``): commit masks, tables and stats bit-identical."""
    from repro_torch.core import distributed as D
    from repro_torch.launch.txn_bench import make_workload
    cpu = torch.device("cpu")
    for src, (kind, kw) in sources.items():
        wl = make_workload(kind, **kw)
        _, stacked = dist_draws(wl, waves, lanes, cpu)
        on_dev = tuple(x.to(dev) for x in stacked)
        for cc, gran, fuse in configs[src]:
            cfg = dist_config(wl, cc, gran, fuse, lanes)
            a = run_sharded(cfg, group, on_dev, dev)
            b = run_sharded(cfg, cpu_group, stacked, cpu)
            what = (f"{src} {cc}-{'fine' if gran else 'coarse'}"
                    + ("" if fuse else " unfused"))
            _same_run(a[:3], b[:3], f"sharded cross-device {what}")
            st = a[2].to(torch.int64).sum(dim=0).tolist()
            log(f"  {what}: {waves} waves, commits {st[D.STAT_COMMITS]} "
                f"aborts {st[D.STAT_ABORTS]} "
                f"dropped ops {st[D.STAT_DROPPED_OPS]} phantoms "
                f"{st[D.STAT_CAUSE0 + CAUSE_PHANTOM]}: "
                f"identical on {dev} and cpu")


# ------------------------------------------------- sharded open loop
#: The sharded open loop's settings (ROADMAP A.11's first item): arrivals
#: a wave over the ranks, each rank's queue, incarnations, histogram bins.
DIST_OPEN = dict(rate=192.0, queue_cap=1024, max_incarnations=8,
                 lat_bins=32)
DIST_OPEN_CONFIGS = (("occ", 0), ("occ", 1), ("mvcc", 0), ("mvcc", 1))


def dist_open_config(wl, cc, gran, lanes, ns):
    """The sharded open loop's DistConfig: ``dist_config``'s, for ``lanes``
    global lanes over ``ns`` ranks, with ``DIST_OPEN``'s queue."""
    return dataclasses.replace(
        dist_config(wl, cc, gran, True, lanes // ns),
        queue_cap=DIST_OPEN["queue_cap"],
        max_incarnations=DIST_OPEN["max_incarnations"],
        lat_bins=DIST_OPEN["lat_bins"])


def _open_identities(s, what, depth=1):
    """The sharded open loop's conservation identities, exactly.  At depth
    >= 2 a retry the full ring rejects counts in inc_drops but keeps its
    validation cause, so the inc_cap causes are at most inc_drops."""
    inc_cap = s["abort_causes"][0]
    if not (s["admitted"] == s["commits"] + s["queued_final"] + s["inc_drops"]
            and s["offered"] == s["admitted"] + s["arrival_drops"]
            and int(s["lat_hist"].sum()) == s["commits"]
            and (inc_cap == s["inc_drops"] if depth == 1
                 else inc_cap <= s["inc_drops"])
            and sum(s["abort_causes"]) == s["aborts"]):
        counts = {k: v for k, v in s.items()
                  if k not in ("lat_hist", "per_shard_stats")}
        raise AssertionError(f"{what}: a conservation identity fails: "
                             f"{counts}")


def sharded_open_path(dev, group=None, waves=WAVES, lanes=DIST_LANES,
                      source=DIST_SOURCES["ycsb"],
                      configs=DIST_OPEN_CONFIGS):
    """The sharded open loop (core/distributed.run_open_loop, depth 1) on
    ``group``'s shards: the source's fresh batches (the port's generator
    on ``dev``) as each wave's candidates, ``DIST_OPEN``'s Poisson
    arrivals split over the ranks (``PoissonArrivals.shard_counts``, seed
    7).  Every conservation identity holds exactly; every wave launches
    route_pack, the claim kernel (wave_commit, or claim_probe on both
    channels and the ring), the install kernel, verdict_pack and
    verdict_unpack once each.  Goodput (commits per host second),
    p50/p99 time-to-commit and waves/s printed.  The counters are set to
    0 just before each run and read just after.  Returns (launches over
    the runs, waves)."""
    from repro_torch import kernels as K
    from repro_torch.core import distributed as D
    from repro_torch.core.admission import ttc_percentiles
    from repro_torch.launch.txn_bench import make_workload
    from repro_torch.workloads.arrivals import PoissonArrivals
    ns = D.n_shards(group)
    wl = make_workload(source[0], **source[1])
    _, stacked = dist_draws(wl, waves, lanes, dev, seed=17)

    def gen(w):
        return tuple(x[w] for x in stacked)
    arrivals = PoissonArrivals(rate=DIST_OPEN["rate"], seed=7)
    counts = arrivals.shard_counts(waves, ns, lanes // ns)
    total = {op: 0 for op in K.WRAPPERS}
    # A short run first: no configuration's pace pays for first use.
    D.run_open_loop(dist_open_config(wl, *configs[0], lanes, ns),
                    counts[:3], gen, 3, group, dev)
    for cc, gran in configs:
        cfg = dist_open_config(wl, cc, gran, lanes, ns)
        what = f"sharded open {cc}-{'fine' if gran else 'coarse'}"
        K.reset_launches()
        s = D.run_open_loop(cfg, counts, gen, waves, group, dev)
        launches, calls = K.launch_counts(), K.call_counts()
        for op in total:
            total[op] += launches[op]
        _open_identities(s, what)
        (p50,), (p99,) = ttc_percentiles(s["lat_hist"].sum(axis=0)[None, :])
        log(f"  {what}: {ns} rank(s) x {lanes // ns} lanes, rate "
            f"{DIST_OPEN['rate']:g}, queue {cfg.queue_cap}: goodput "
            f"{s['commits'] / s['wall_s']:.1f} txn/s, p50 {p50:g} p99 "
            f"{p99:g} waves, {waves / s['wall_s']:.1f} waves/s; offered "
            f"{s['offered']} admitted {s['admitted']} commits "
            f"{s['commits']} queued {s['queued_final']} inc_drops "
            f"{s['inc_drops']} arrival_drops {s['arrival_drops']} causes "
            f"{s['abort_causes']}")
        once = ("route_pack", "verdict_pack", "verdict_unpack",
                "claim_probe" if cfg.is_mv else "wave_commit",
                "mv_install" if cfg.is_mv else "commit_install")
        for op in once:
            if calls[op] != waves or (dev.type == "cuda"
                                      and launches[op] != waves):
                raise AssertionError(f"{what}: {op} calls {calls[op]}, "
                                     f"launches {launches[op]} over {waves} "
                                     "waves (one a wave)")
        if s["commits"] <= 0:
            raise AssertionError(f"{what}: nothing committed")
    log(f"  sharded open launches {total}")
    return total, len(configs) * waves


def sharded_open_cross_device(dev, group=None, cpu_group=None, waves=30,
                              lanes=DIST_LANES,
                              source=DIST_CROSS_SOURCES["ycsb"],
                              configs=(("occ", 1), ("mvcc", 0))):
    """The same CPU-made candidates and arrival counts through the
    sharded open wave on ``dev`` (the kernels, over ``group``) and on the
    CPU (the plain versions, over the gloo ``cpu_group``), wave by wave:
    commit masks, stats and every field of the queue state bit-identical,
    then the tables."""
    import torch.distributed as dist
    from repro_torch.core import distributed as D
    from repro_torch.launch.txn_bench import make_workload
    from repro_torch.workloads.arrivals import PoissonArrivals
    cpu = torch.device("cpu")
    ns = D.n_shards(group)
    T = lanes // ns
    mine = slice(dist.get_rank(group) * T, (dist.get_rank(group) + 1) * T)
    wl = make_workload(source[0], **source[1])
    _, stacked = dist_draws(wl, waves, lanes, cpu, seed=19)
    counts = PoissonArrivals(rate=DIST_OPEN["rate"], seed=3).shard_counts(
        waves, ns, T)
    for cc, gran in configs:
        cfg = dist_open_config(wl, cc, gran, lanes, ns)
        runs = []
        for d, g in ((dev, group), (cpu, cpu_group)):
            wave = D.make_open_wave_fn(cfg, g)
            tables = D.init_tables(cfg, g, d)
            q = D.init_open_queue(cfg, g, d)
            outs = []
            for w in range(waves):
                c, tables, q, st = wave(
                    *(x[w][mine].to(d).contiguous() for x in stacked),
                    int(counts[w, dist.get_rank(g)]), tables, q, w)
                outs.append((c.cpu(), st.cpu(), [x.cpu() for x in q]))
            runs.append((outs, [x.cpu() for x in tables]))
        what = f"sharded open cross-device {cc}-{'fine' if gran else 'coarse'}"
        for w, (a, b) in enumerate(zip(runs[0][0], runs[1][0])):
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                    and all(torch.equal(x, y) for x, y in zip(a[2], b[2]))):
                raise AssertionError(f"{what}: wave {w} differs")
        for i, (x, y) in enumerate(zip(*(r[1] for r in runs))):
            if not torch.equal(x, y):
                raise AssertionError(f"{what}: table {i} differs")
        st = torch.stack([o[1] for o in runs[0][0]]).to(torch.int64).sum(0)
        log(f"  {what}: {waves} waves, commits {int(st[D.STAT_COMMITS])} "
            f"admitted {int(st[D.STAT_ADMITTED])}: identical on {dev} and "
            "cpu")


# ------------------------------------------------- sharded pipeline
#: The pipelined phases' depth, forced on one rank (DistConfig.depth keeps
#: one shard at depth 1, as the JAX package's).
PIPE_DEPTH = 2


def _fused_bytes(cfg, ns):
    """Bytes of one pipelined step's exchange: [key | meta | V | C]."""
    from repro_torch.core import distributed as D
    cap = cfg.cap(ns)
    return ns * (2 * cap + 2 * D.verdict_words(cap)) * 4


def _once_a_step(what, cov, launches, calls, steps, dev):
    """Every kernel of the mechanism ran, once each step."""
    for op, v in cov.items():
        if v != "not_run" and (calls[op] != steps or (
                dev.type == "cuda" and launches[op] != steps)):
            raise AssertionError(f"{what}: {op} calls {calls[op]}, "
                                 f"launches {launches[op]} over {steps} "
                                 "steps (one a step)")


def sharded_pipeline_path(dev, kept, depth1_rows, group=None, waves=WAVES,
                          lanes=DIST_LANES, sources=DIST_SOURCES,
                          configs=DIST_CONFIGS):
    """The software-pipelined closed loop (core/distributed._pipelined_run)
    forced to depth 2 on ``group``'s shards, on the draws ``sharded_path``
    kept (``kept``): commit masks, stats and tables bit-identical to its
    synchronous runs, every kernel of the mechanism "cuda" and launched
    once a step, ``n_waves + 3`` exchanges of the fused buffer.  Waves/s
    and device operations a wave (a report, no gate) beside depth 1's
    (``depth1_rows``).  The counters are set to 0 just before each run
    and read just after.  Returns (launches over the runs, steps)."""
    from repro_torch import kernels as K
    from repro_torch.core import distributed as D
    from repro_torch.core.backend import dist_kernel_coverage
    from repro_torch.launch.txn_bench import make_workload
    ns = D.n_shards(group)
    steps = waves + 3
    total = {op: 0 for op in K.WRAPPERS}
    for src, (kind, kw) in sources.items():
        wl = make_workload(kind, **kw)
        stacked = kept[src]
        for cc, gran, fuse in configs[src]:
            cfg = dataclasses.replace(dist_config(wl, cc, gran, fuse, lanes),
                                      pipeline_depth=PIPE_DEPTH)
            name = (f"{src} {cc}-{'fine' if gran else 'coarse'}"
                    + ("" if fuse else " unfused"))
            what = f"sharded pipeline {name}"
            K.reset_launches()
            out = run_sharded(cfg, group, stacked, dev, pipelined=True)
            launches, calls = K.launch_counts(), K.call_counts()
            for op in total:
                total[op] += launches[op]
            _same_run(out[:3], kept[name], f"{what} vs the synchronous run")
            exchange = out[4]
            if (exchange.calls != steps
                    or exchange.bytes_sent != steps * _fused_bytes(cfg, ns)):
                raise AssertionError(
                    f"{what}: {exchange.calls} exchanges of "
                    f"{exchange.bytes_sent} B, expected {steps} of "
                    f"{_fused_bytes(cfg, ns)} B")
            cov = dist_kernel_coverage(cc, launches, calls, fuse)
            want = {op: ("not_run" if op == "iterate_validate"
                         and cfg.max_extent == 1
                         else "cuda" if dev.type == "cuda" else "torch")
                    for op in cov}
            if cov != want:
                raise AssertionError(f"{what}: kernel_ops {cov} != {want}")
            _once_a_step(what, cov, launches, calls, steps, dev)
            prof = _profile_run(cfg, group, stacked, dev, pipelined=True)
            d1 = depth1_rows[name]
            log(f"  {name:24s} depth {PIPE_DEPTH}: {waves / out[3]:.1f} "
                f"waves/s (depth 1 {d1['waves_per_s']:.1f}), {steps} "
                f"exchanges of {_fused_bytes(cfg, ns)} B, device ops/wave "
                f"{prof.get('device_events_per_wave', 'not measured')} "
                f"(depth 1 {d1.get('device_events_per_wave', 'not measured')}"
                f"), busy ms/wave "
                f"{prof.get('device_busy_ms_per_wave', 'not measured')} "
                f"(depth 1 "
                f"{d1.get('device_busy_ms_per_wave', 'not measured')}), "
                f"idle {prof.get('device_idle_share', 'not measured')}: "
                "identical to depth 1")
    log(f"  sharded pipeline launches {total}")
    return total, steps * sum(len(c) for c in configs.values())


def sharded_open_pipeline_path(dev, group=None, waves=WAVES,
                               lanes=DIST_LANES,
                               source=DIST_SOURCES["ycsb"],
                               configs=DIST_OPEN_CONFIGS,
                               no_retry=(("occ", 1), ("mvcc", 0))):
    """The pipelined open loop (core/distributed._open_loop at depth 2,
    forced on ``group``'s shards) with ``sharded_open_path``'s source,
    arrivals and queue: the conservation identities exact (a retry the
    full ring rejects drops into inc_drops, keeping its cause), every
    kernel of the mechanism once a step, ``n_waves + 3`` exchanges of the
    fused buffer; goodput and p50/p99 printed.  With max_incarnations=0
    (``no_retry``) every counter, the histogram and the per-rank stats
    equal depth 1's.  Returns (launches over the timed runs, steps)."""
    from repro_torch import kernels as K
    from repro_torch.core import distributed as D
    from repro_torch.core.admission import ttc_percentiles
    from repro_torch.core.backend import dist_kernel_coverage
    from repro_torch.launch.txn_bench import make_workload
    from repro_torch.workloads.arrivals import PoissonArrivals
    ns = D.n_shards(group)
    wl = make_workload(source[0], **source[1])
    _, stacked = dist_draws(wl, waves, lanes, dev, seed=17)

    def gen(w):
        return tuple(x[w] for x in stacked)
    counts = PoissonArrivals(rate=DIST_OPEN["rate"], seed=7).shard_counts(
        waves, ns, lanes // ns)
    steps = waves + 3
    total = {op: 0 for op in K.WRAPPERS}
    for cc, gran in configs:
        cfg = dataclasses.replace(dist_open_config(wl, cc, gran, lanes, ns),
                                  pipeline_depth=PIPE_DEPTH)
        what = (f"sharded open pipeline {cc}-"
                f"{'fine' if gran else 'coarse'}")
        K.reset_launches()
        s = D._open_loop(cfg, counts, gen, waves, group, dev, None,
                         PIPE_DEPTH)
        launches, calls = K.launch_counts(), K.call_counts()
        for op in total:
            total[op] += launches[op]
        _open_identities(s, what, depth=PIPE_DEPTH)
        _once_a_step(what, dist_kernel_coverage(cc, launches, calls),
                     launches, calls, steps, dev)
        if s["exchange_bytes"] != steps * _fused_bytes(cfg, ns):
            raise AssertionError(f"{what}: {s['exchange_bytes']} B "
                                 "exchanged")
        (p50,), (p99,) = ttc_percentiles(s["lat_hist"].sum(axis=0)[None, :])
        log(f"  {what}: goodput {s['commits'] / s['wall_s']:.1f} txn/s, "
            f"p50 {p50:g} p99 {p99:g} waves, {waves / s['wall_s']:.1f} "
            f"waves/s; offered {s['offered']} admitted {s['admitted']} "
            f"commits {s['commits']} queued {s['queued_final']} inc_drops "
            f"{s['inc_drops']} (inc_cap causes {s['abort_causes'][0]}) "
            f"arrival_drops {s['arrival_drops']}")
        if s["commits"] <= 0:
            raise AssertionError(f"{what}: nothing committed")
    for cc, gran in no_retry:
        cfg = dataclasses.replace(dist_open_config(wl, cc, gran, lanes, ns),
                                  max_incarnations=0)
        a, b = (D._open_loop(cfg, counts, gen, waves, group, dev, None, d)
                for d in (1, PIPE_DEPTH))
        what = (f"sharded open pipeline {cc}-{'fine' if gran else 'coarse'}"
                " without retries")
        for k, v in a.items():
            if k not in ("wall_s", "exchange_bytes") and not np.array_equal(
                    np.asarray(b[k]), np.asarray(v)):
                raise AssertionError(f"{what}: {k} {b[k]} != depth 1's {v}")
        log(f"  {what}: every counter and lat_hist equal to depth 1's "
            f"(commits {a['commits']}, inc_drops {a['inc_drops']})")
    log(f"  sharded open pipeline launches {total}")
    return total, steps * len(configs)


def sharded_pipeline_cross_device(dev, group=None, cpu_group=None,
                                  waves=30, lanes=DIST_LANES,
                                  sources=DIST_CROSS_SOURCES,
                                  configs=DIST_CROSS_CONFIGS,
                                  open_source=DIST_CROSS_SOURCES["ycsb"],
                                  open_configs=(("occ", 1), ("mvcc", 0))):
    """Both pipelined runners on ``dev`` (over ``group``) and on the CPU
    (the plain versions, over the gloo ``cpu_group``) on the same
    CPU-made draws: the closed runner's commit masks and stats wave by
    wave and its tables, then the open runner's commit masks and stats
    wave by wave, queue state and tables, bit-identical."""
    import torch.distributed as dist
    from repro_torch.core import distributed as D
    from repro_torch.launch.txn_bench import make_workload
    from repro_torch.workloads.arrivals import PoissonArrivals
    cpu = torch.device("cpu")
    for src, (kind, kw) in sources.items():
        wl = make_workload(kind, **kw)
        _, stacked = dist_draws(wl, waves, lanes, cpu)
        on_dev = tuple(x.to(dev) for x in stacked)
        for cc, gran, fuse in configs[src]:
            cfg = dist_config(wl, cc, gran, fuse, lanes)
            a = run_sharded(cfg, group, on_dev, dev, pipelined=True)
            b = run_sharded(cfg, cpu_group, stacked, cpu, pipelined=True)
            what = (f"{src} {cc}-{'fine' if gran else 'coarse'}"
                    + ("" if fuse else " unfused"))
            _same_run(a[:3], b[:3], f"sharded pipeline cross-device {what}")
            log(f"  pipelined {what}: {waves} waves identical on {dev} and "
                "cpu")
    ns = D.n_shards(group)
    T = lanes // ns
    rank = dist.get_rank(group)
    mine = slice(rank * T, (rank + 1) * T)
    wl = make_workload(open_source[0], **open_source[1])
    _, stacked = dist_draws(wl, waves, lanes, cpu, seed=19)
    counts = PoissonArrivals(rate=DIST_OPEN["rate"], seed=3).shard_counts(
        waves, ns, T)
    for cc, gran in open_configs:
        cfg = dist_open_config(wl, cc, gran, lanes, ns)
        runs = []
        for d, g in ((dev, group), (cpu, cpu_group)):
            run = D._open_pipelined_run(cfg, waves, g)
            out = run(*(x[:, mine].to(d).contiguous() for x in stacked),
                      torch.from_numpy(counts[:, dist.get_rank(g)]).to(d),
                      D.init_tables(cfg, g, d), D.init_open_queue(cfg, g, d))
            runs.append([x.cpu() for x in (out[0], out[3], *out[2],
                                           *out[1])])
        what = (f"sharded open pipeline cross-device "
                f"{cc}-{'fine' if gran else 'coarse'}")
        for w in range(waves):
            for i in (0, 1):
                if not torch.equal(runs[0][i][w], runs[1][i][w]):
                    raise AssertionError(f"{what}: wave {w} differs")
        for i, (x, y) in enumerate(zip(*runs)):
            if not torch.equal(x, y):
                raise AssertionError(f"{what}: output {i} differs")
        log(f"  {what}: {waves} waves, commits {int(runs[0][0].sum())}: "
            f"identical on {dev} and cpu")


def axiswise_path(dev, shards, waves=20, lanes=DIST_LANES,
                  source=DIST_SOURCES["ycsb"]):
    """The axis-wise exchange on the one-rank ``shards.mesh_shape`` (1, 1)
    mesh (its subgroups made by launch/mesh.init_shards): the synchronous
    and the pipelined runner equal the flat exchange's bit for bit, with
    one collective per axis and twice the modelled wire bytes."""
    from repro_torch.core import distributed as D
    from repro_torch.launch.txn_bench import make_workload
    wl = make_workload(source[0], **source[1])
    _, stacked = dist_draws(wl, waves, lanes, dev, seed=23)
    base = dist_config(wl, "mvocc", 1, True, lanes)
    for pipelined in (False, True):
        flat = run_sharded(base, None, stacked, dev, pipelined)
        cfg = dataclasses.replace(base, topology="axiswise")
        axis = run_sharded(cfg, None, stacked, dev, pipelined,
                           shards.mesh_shape)
        what = f"axis-wise {shards.mesh_shape} " + (
            "pipelined" if pipelined else "synchronous")
        _same_run(axis[:3], flat[:3], f"{what} vs flat")
        hops = len(shards.mesh_shape)
        steps = waves + 3 if pipelined else waves
        model = D.wire_bytes_per_wave(cfg, 1, shards.mesh_shape)
        if not (axis[4].calls == hops * flat[4].calls
                and axis[4].bytes_sent == hops * flat[4].bytes_sent
                == hops * steps * D.wire_bytes_per_wave(base, 1)[
                    "wire_bytes_per_wave"]
                and axis[4].bytes_sent
                == steps * model["wire_bytes_per_wave"]):
            raise AssertionError(
                f"{what}: {axis[4].calls} calls, {axis[4].bytes_sent} B; "
                f"flat {flat[4].calls}, {flat[4].bytes_sent} B")
        log(f"  {what}: {waves} waves equal to the flat exchange, "
            f"{axis[4].calls} collectives ({hops} an exchange), "
            f"{axis[4].bytes_sent} B = {hops} x flat's")


# ------------------------------------------------------------- LM serving
#: The language-model kernels (slice 5): source and the TPU kernel each
#: replaces.
LM_KERNEL_META = {
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:80"),
    "rglru": ("src/repro_torch/csrc/rglru.cu",
              "src/repro/kernels/rglru_scan.py:38"),
    "rwkv6": ("src/repro_torch/csrc/rwkv6.cu",
              "src/repro/kernels/rwkv6_scan.py:43"),
}
#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet).
PEAK_BF16_OPS_PER_S = 989e12
#: The served models at full width, and their traffic: 4 requests of
#: 3,072-token prompts (longer than recurrentgemma's 2,048 window and the
#: JAX kernels' 2,048-step chunk), 32 tokens each.  qwen2-7b (28 layers,
#: GQA 32/4 at D 128, causal) is the dense family (ROADMAP A.12.1).
LM_ARCHS = ("recurrentgemma-9b", "rwkv6-3b", "qwen2-7b")
LM_TRAFFIC = dict(n_requests=4, prompt_len=3072, gen=32)
#: Relative L2 error allowed between the kernel route's and the plain
#: route's last-position logits on the card (the float32 model; the bf16
#: model's is reported against it, see lm_serve_path).
LM_ROUTE_RTOL = 1e-2
#: Kernel-check cases: (label, shape dict, dtype).  The first of each is
#: the full-width prefill shape, the second decode (S = 1).
FLASH_CASES = (
    ("rg9b-prefill", dict(B=4, Hq=16, Hkv=1, Sq=3072, Sk=3072, D=256,
                          causal=True, window=2048), torch.bfloat16),
    ("S=1", dict(B=4, Hq=16, Hkv=1, Sq=1, Sk=2048, D=256, causal=False,
                 window=None), torch.bfloat16),
    ("ragged sk_valid rep4", dict(B=2, Hq=8, Hkv=2, Sq=100, Sk=300, D=64,
                                  causal=True, window=64, sk_valid=250),
     torch.float32),
    ("rep1 D128", dict(B=1, Hq=4, Hkv=4, Sq=200, Sk=200, D=128,
                       causal=True, window=None), torch.float32),
    ("rep16 window", dict(B=1, Hq=16, Hkv=1, Sq=130, Sk=130, D=256,
                          causal=True, window=50), torch.bfloat16),
    ("full D64", dict(B=2, Hq=4, Hkv=1, Sq=70, Sk=70, D=64, causal=False,
                      window=None), torch.bfloat16),
    ("sq_valid", dict(B=1, Hq=4, Hkv=2, Sq=64, Sk=100, D=128, causal=True,
                      window=None, sq_valid=40, sk_valid=90),
     torch.float32),
    ("D16", dict(B=2, Hq=4, Hkv=2, Sq=45, Sk=45, D=16, causal=True,
                 window=32), torch.float32),
    ("D32", dict(B=2, Hq=2, Hkv=1, Sq=77, Sk=77, D=32, causal=True,
                 window=32), torch.bfloat16),
)
#: Edges of the bfloat16 tensor-core kernel: Sq = 65 (a ragged 128-row
#: block) and Sq = 1 at D 256, a window of 16 inside one 64-key tile, GQA
#: 16 with sk_valid < Sk, D 16 and D 32 with rows that see no key.
FLASH_BF16_EDGE_CASES = (
    ("bf16 Sq=65 D256", dict(B=1, Hq=2, Hkv=1, Sq=65, Sk=65, D=256,
                             causal=True, window=None), torch.bfloat16),
    ("bf16 Sq=1 D256 causal", dict(B=2, Hq=4, Hkv=1, Sq=1, Sk=300, D=256,
                                   causal=True, window=None),
     torch.bfloat16),
    ("bf16 window 16", dict(B=1, Hq=4, Hkv=1, Sq=150, Sk=150, D=64,
                            causal=True, window=16), torch.bfloat16),
    ("bf16 rep16 sk_valid", dict(B=1, Hq=16, Hkv=1, Sq=100, Sk=200, D=128,
                                 causal=True, window=None, sk_valid=170),
     torch.bfloat16),
    ("bf16 D16", dict(B=2, Hq=4, Hkv=2, Sq=90, Sk=90, D=16, causal=True,
                      window=40), torch.bfloat16),
    ("bf16 D32 rows without keys", dict(B=1, Hq=4, Hkv=1, Sq=70, Sk=130,
                                        D=32, causal=True, window=None,
                                        sq_valid=60, sk_valid=40),
     torch.bfloat16),
)
FLASH_CASES = FLASH_CASES + FLASH_BF16_EDGE_CASES
RGLRU_CASES = (
    ("rg9b-prefill", dict(B=4, S=3072, D=4096), torch.bfloat16),
    ("S=1", dict(B=4, S=1, D=4096), torch.bfloat16),
    ("ragged f32", dict(B=2, S=1000, D=300), torch.float32),
    ("short bf16", dict(B=3, S=17, D=4096), torch.bfloat16),
) + (
    # The staged walk's edges: a = 1 (log_a = 0) and a below 2e-9 (log_a
    # <= -20); S not a multiple of its 64-step tile; D not a multiple of its
    # 64-channel tile, with 16-byte rows (4,104) and without (300, the
    # element-wise copies); B * D smaller than one block.
    ("log_a=0", dict(B=2, S=300, D=512, log_a="zero"), torch.bfloat16),
    ("log_a<=-20", dict(B=2, S=300, D=512, log_a="deep"), torch.bfloat16),
    ("S=1000", dict(B=2, S=1000, D=4096), torch.bfloat16),
    ("D=4104", dict(B=2, S=130, D=4104), torch.bfloat16),
    ("D=300 bf16", dict(B=3, S=200, D=300), torch.bfloat16),
    ("B*D<block", dict(B=1, S=77, D=40), torch.bfloat16),
)
#: rwkv6's decay inputs: "uniform" w in [0.05, 0.95]; "model" w =
#: exp(-exp(z)) with z uniform in [-6, 4], as models/recurrent.py makes it
#: (1.9e-24 to 0.9975); "edge" the model's draw with a tenth of the steps
#: at w = 0 exactly and a tenth at w = 1 exactly.
RWKV_CASES = (
    ("rwkv6-3b-prefill", dict(B=4, H=48, S=3072, Dk=64, Dv=64),
     torch.bfloat16),
    ("S=1", dict(B=4, H=48, S=1, Dk=64, Dv=64), torch.bfloat16),
    ("f32", dict(B=2, H=3, S=100, Dk=64, Dv=64), torch.float32),
    ("Dk16", dict(B=2, H=4, S=37, Dk=16, Dv=16), torch.float32),
    ("Dk32 Dv48", dict(B=1, H=2, S=20, Dk=32, Dv=48), torch.bfloat16),
    ("Dk128", dict(B=1, H=2, S=9, Dk=128, Dv=128), torch.float32),
) + (
    # The chunked kernel's edges (64-token chunks, bf16): the model's decay
    # at the prefill shape, w = 0 and 1 exactly, S = L - 1 (the recurrent
    # kernel), L, L + 1 and 1,000, and every key width at S >= L.
    ("prefill model decay", dict(B=4, H=48, S=3072, Dk=64, Dv=64,
                                 decay="model"), torch.bfloat16),
    ("w 0 and 1", dict(B=2, H=4, S=300, Dk=64, Dv=64, decay="edge"),
     torch.bfloat16),
    ("S=L-1", dict(B=2, H=4, S=63, Dk=64, Dv=64, decay="model"),
     torch.bfloat16),
    ("S=L", dict(B=2, H=4, S=64, Dk=64, Dv=64, decay="model"),
     torch.bfloat16),
    ("S=L+1", dict(B=2, H=4, S=65, Dk=64, Dv=64, decay="model"),
     torch.bfloat16),
    ("S=1000", dict(B=2, H=4, S=1000, Dk=64, Dv=64, decay="model"),
     torch.bfloat16),
    ("chunked Dk16", dict(B=2, H=3, S=200, Dk=16, Dv=16, decay="model"),
     torch.bfloat16),
    ("chunked Dk32 Dv48", dict(B=1, H=2, S=130, Dk=32, Dv=48,
                               decay="model"), torch.bfloat16),
    ("chunked Dk128 Dv128", dict(B=1, H=2, S=150, Dk=128, Dv=128,
                                 decay="model"), torch.bfloat16),
)

def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance of two bfloat16 tensors in units in the last
    place."""
    def ordered(x):
        i = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i >= 0, i, -(i & 0x7FFF))
    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


class LMCheck:
    """A kernel against its plain version: float32 within rtol 1e-5 /
    atol 1e-5; bfloat16 within 2 bf16 ulps (values within 1e-5 of each
    other pass: near 0 one float32 rounding step spans many ulps)."""

    def __init__(self, name):
        self.name, self.cases, self.max_err, self.max_ulps = name, 0, 0.0, 0

    def compare(self, label, got, want):
        """Raise unless ``got`` meets ``want``; returns this case's (max abs
        error, max bf16 ulps)."""
        case_err, case_ulps = 0.0, 0
        for i, (a, b) in enumerate(zip(got, want)):
            what = f"{self.name} {label} output {i}"
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"{what}: {a.dtype}{tuple(a.shape)} "
                                     f"vs {b.dtype}{tuple(b.shape)}")
            if not bool(torch.isfinite(a.float()).all()):
                raise AssertionError(f"{what}: not finite")
            err = (a.float() - b.float()).abs()
            if err.numel():
                case_err = max(case_err, float(err.max()))
            if a.dtype == torch.bfloat16:
                far = err > 1e-5
                ulps = bf16_ulps(a[far], b[far])
                case_ulps = max(case_ulps, ulps)
                if ulps > 2:
                    raise AssertionError(f"{what}: {ulps} bf16 ulps apart")
            elif not bool((err <= 1e-5 + 1e-5 * b.float().abs()).all()):
                raise AssertionError(f"{what}: beyond rtol/atol 1e-5 (max "
                                     f"abs err {float(err.max())})")
        self.max_err = max(self.max_err, case_err)
        self.max_ulps = max(self.max_ulps, case_ulps)
        self.cases += 1
        return case_err, case_ulps


def _randn(shape, dev, gen, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


def flash_inputs(s, dtype, dev, gen):
    D = s["D"]
    q = _randn((s["B"], s["Hq"], s["Sq"], D), dev, gen, D ** -0.25, dtype)
    k = _randn((s["B"], s["Hkv"], s["Sk"], D), dev, gen, D ** -0.25, dtype)
    v = _randn((s["B"], s["Hkv"], s["Sk"], D), dev, gen, 1.0, dtype)
    kw = dict(causal=s["causal"], window=s["window"],
              sq_valid=s.get("sq_valid"), sk_valid=s.get("sk_valid"))
    return (q, k, v), kw


def rglru_inputs(s, dtype, dev, gen):
    B, S, D = s["B"], s["S"], s["D"]
    # log_a as the model makes it: -8 softplus(lam) sigmoid(.) in [-0.1, 0);
    # "zero": a = 1; "deep": log_a in [-30, -20].
    # "edge": a third of the elements at 0, a third in [-30, -20].
    log_a = torch.rand((B, S, D), generator=gen, device=dev)
    if s.get("log_a") == "edge":
        pick = torch.rand((B, S, D), generator=gen, device=dev)
        log_a = torch.where(pick < 1 / 3, 0.0, torch.where(
            pick < 2 / 3, -20.0 - 10.0 * log_a, -0.1 * log_a))
    else:
        log_a = {None: -0.1 * log_a, "zero": 0.0 * log_a,
                 "deep": -20.0 - 10.0 * log_a}[s.get("log_a")]
    return (log_a, _randn((B, S, D), dev, gen, 1.0, dtype),
            _randn((B, D), dev, gen)), {}


def rwkv_decay(shape, mode, dev, gen):
    """w of RWKV_CASES' decay ``mode``: "uniform"; "model" (w = exp(-exp(z)),
    z in [-6, 4]: 1.9e-24 to 0.9975); "edge" (that draw with a tenth of
    the steps at w = 0 and a tenth at 1 exactly); "1e-24" (a third at
    exp(-exp(4)) = 1.9e-24 and a third at 1 exactly)."""
    if mode == "uniform":
        return torch.rand(shape, generator=gen, device=dev) * 0.9 + 0.05
    z = torch.rand(shape, generator=gen, device=dev) * 10.0 - 6.0
    w = torch.exp(-torch.exp(z))
    if mode == "edge":
        pick = torch.rand(shape, generator=gen, device=dev)
        w = torch.where(pick < 0.1, torch.zeros_like(w), w)
        w = torch.where(pick > 0.9, torch.ones_like(w), w)
    elif mode == "1e-24":
        pick = torch.rand(shape, generator=gen, device=dev)
        w = torch.where(pick < 1 / 3, torch.full_like(w, math.exp(
            -math.exp(4.0))), w)
        w = torch.where(pick > 2 / 3, torch.ones_like(w), w)
    return w


def rwkv_inputs(s, dtype, dev, gen):
    B, H, S, Dk, Dv = s["B"], s["H"], s["S"], s["Dk"], s["Dv"]
    r = _randn((B, H, S, Dk), dev, gen, 0.5, dtype)
    k = _randn((B, H, S, Dk), dev, gen, 0.5, dtype)
    v = _randn((B, H, S, Dv), dev, gen, 1.0, dtype)
    w = rwkv_decay((B, H, S, Dk), s.get("decay", "uniform"), dev, gen)
    u = _randn((H, Dk), dev, gen)
    s0 = _randn((B, H, Dk, Dv), dev, gen)
    return (r, k, v, w, u, s0), {}


def flash_work(s, dtype, dev) -> tuple[float, float, float]:
    """(bytes, operations, peak rate) of one call: q, k, v read once and
    out written once; 4 D flops per visible (q, k) pair of this mask."""
    from repro_torch.kernels.flash_attention import attention_mask
    Sq, Sk = s["Sq"], s["Sk"]
    mask = attention_mask(Sq, Sk, causal=s["causal"], window=s["window"],
                          sq_valid=s.get("sq_valid") or Sq,
                          sk_valid=s.get("sk_valid") or Sk, device=dev)
    pairs = int(mask.sum()) * s["B"] * s["Hq"]
    el = torch.finfo(dtype).bits // 8
    n_bytes = el * s["D"] * (2 * s["B"] * s["Hq"] * Sq
                             + 2 * s["B"] * s["Hkv"] * Sk)
    rate = PEAK_BF16_OPS_PER_S if dtype == torch.bfloat16 else PEAK_OPS_PER_S
    return n_bytes, 4.0 * s["D"] * pairs, rate


def rglru_work(s, dtype, dev):
    n = s["B"] * s["S"] * s["D"]
    el = torch.finfo(dtype).bits // 8
    # log_a (f32) and x read, h written; h0 read and h_last written (f32);
    # an exp, a sqrt and five flops an element.
    return (n * (4 + 2 * el) + 8 * s["B"] * s["D"], 7.0 * n,
            PEAK_OPS_PER_S)


def rwkv_work(s, dtype, dev):
    B, H, S, Dk, Dv = s["B"], s["H"], s["S"], s["Dk"], s["Dv"]
    el = torch.finfo(dtype).bits // 8
    n_bytes = (el * B * H * S * (2 * Dk + 2 * Dv) + 4 * B * H * S * Dk
               + 4 * H * Dk + 8 * B * H * Dk * Dv)
    return n_bytes, 4.0 * B * H * S * Dk * Dv, PEAK_OPS_PER_S


def _flash_library(args, kw):
    """One PyTorch call computing the same function: scaled dot-product
    attention with the same boolean mask (kv heads repeated first,
    outside the timing).  A yardstick only; the port never calls it."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import attention_mask
    q, k, v = args
    rep = q.shape[1] // k.shape[1]
    kk, vv = (k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1))
    Sq, Sk = q.shape[2], k.shape[2]
    mask = attention_mask(Sq, Sk, causal=kw["causal"], window=kw["window"],
                          sq_valid=kw["sq_valid"] or Sq,
                          sk_valid=kw["sk_valid"] or Sk, device=q.device)
    return lambda: F.scaled_dot_product_attention(q, kk, vv, attn_mask=mask)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


#: The C entries (repro_<name>) whose parent build ``--parent`` times
#: beside this checkout's kernels: the kernels the change redesigned, each
#: with its source (csrc/<source>.cu) and its ctypes argtypes in the
#: parent's tree, which bind it (a parent bound with this checkout's
#: signature crashes).  rwkv6's backward: the parent's recurrent
#: repro_rwkv6_bwd and its scratch size, timed by recurrent_backward_phase
#: through parent_rwkv6_bwd.
PARENT_KERNELS = {
    "rwkv6_bwd": ("rwkv6_bwd", [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6
                  + [ctypes.c_void_p]),
    "rwkv6_bwd_scratch": ("rwkv6_bwd", [ctypes.c_int] * 6
                          + [ctypes.POINTER(ctypes.c_longlong)])}


def parent_kernels(parent_root: str) -> dict:
    """{name: C entry} of another build of PARENT_KERNELS (a parent
    commit's, unpacked at ``parent_root``): its csrc sources built with
    the port's nvcc flags into build/parent_kernels, each entry bound with
    the parent's own C signature, so a phase times both builds on the
    same inputs in one process."""
    from repro_torch.kernels import build
    out_dir = os.path.join(ROOT, "build", "parent_kernels")
    os.makedirs(out_dir, exist_ok=True)
    csrc = os.path.join(parent_root, "src", "repro_torch", "csrc")
    t0 = time.perf_counter()
    procs = {src: subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
         os.path.join(out_dir, f"{src}.so"), os.path.join(csrc,
                                                          f"{src}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in {v[0] for v in PARENT_KERNELS.values()}}
    for src, p in procs.items():
        text, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {csrc}/{src}.cu:\n{text}")
    log(f"parent build: {time.perf_counter() - t0:.2f} s for "
        f"{sorted(procs)}")
    fns = {}
    for n, (src, argtypes) in PARENT_KERNELS.items():
        fn = getattr(ctypes.CDLL(os.path.join(out_dir, f"{src}.so")),
                     f"repro_{n}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[n] = fn
    return fns


#: qwen2-7b's prefill shape (4 prompts of 3,072 tokens, GQA 32/4 at D
#: 128, causal), where flash_attention is timed beside SDPA as well.
FLASH_DENSE_PREFILL = dict(B=4, Hq=32, Hkv=4, Sq=3072, Sk=3072, D=128,
                           causal=True, window=None)


def flash_dense_timing(dev, gen, s=FLASH_DENSE_PREFILL,
                       dtype=torch.bfloat16) -> dict:
    """flash_attention timed at qwen2-7b's prefill shape beside its bound
    and two SDPA calls: with the same boolean mask (kv heads repeated
    first), and with is_causal and enable_gqa.  Yardsticks only."""
    from repro_torch import kernels as K
    args, kw = flash_inputs(s, dtype, dev, gen)
    n_bytes, n_ops, rate = flash_work(s, dtype, dev)
    row = {"ms": time_ms(lambda: K.flash_attention(*args, **kw), dev),
           "bound_ms": max(n_bytes / PEAK_BYTES_PER_S, n_ops / rate) * 1e3,
           "library_ms": time_ms(_flash_library(args, kw), dev),
           "library_causal_ms": time_ms(_sdpa_causal(args), dev),
           "shape": " ".join(f"{k}={v}" for k, v in s.items())
                    + f" {str(dtype).split('.')[-1]}"}
    log(f"  flash_attention at qwen2-7b's prefill shape: kernel "
        f"{row['ms']:.6f} ms, bound {row['bound_ms']:.6f} ms; SDPA same "
        f"mask {row['library_ms']:.6f} ms, is_causal enable_gqa "
        f"{row['library_causal_ms']:.6f} ms  [{row['shape']}]")
    return row


def lm_kernel_phase(dev, seed=21, cases=None):
    """Each LM kernel against its plain version on the card over its
    cases (full-width prefill shape, S = 1 and the edges; a line per case,
    naming the rwkv6 kernel that served it), then timed at the first
    case's shape (the full-width prefill) beside its plain version, its
    bound and, for flash_attention, the PyTorch yardstick.  ``cases``
    ({name: cases}) replaces the default cases (a rehearsal on the CPU at
    small shapes).  Returns ({name:
    LMCheck}, {name: timing row})."""
    from repro_torch import kernels as K
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.rglru import rglru_plain
    from repro_torch.kernels.rwkv6 import route, rwkv6_plain
    def served(name, s, dtype):   # the CPU launches no kernel
        if name != "rwkv6" or dev.type != "cuda":
            return ""
        return f" ({route(dtype, s['S'])} kernel)"
    table = {
        "flash_attention": (K.flash_attention, flash_attention_plain,
                            FLASH_CASES, flash_inputs, flash_work),
        "rglru": (K.rglru, rglru_plain, RGLRU_CASES, rglru_inputs,
                  rglru_work),
        "rwkv6": (K.rwkv6, rwkv6_plain, RWKV_CASES, rwkv_inputs,
                  rwkv_work),
    }
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    checks, timings = {}, {}
    for name, (kernel, plain, default, inputs, work) in table.items():
        chk = checks[name] = LMCheck(name)
        for i, (label, s, dtype) in enumerate((cases or {}).get(name,
                                                                default)):
            args, kw = inputs(s, dtype, dev, gen)
            got, want = kernel(*args, **kw), plain(*args, **kw)
            _sync(dev)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err, ulps = chk.compare(label, got, want)
            log(f"    {name} {label}{served(name, s, dtype)}: max_abs_err "
                f"{err:.3g}, bf16 ulps {ulps}")
            if i:
                continue
            n_bytes, n_ops, rate = work(s, dtype, dev)
            tb, to = n_bytes / PEAK_BYTES_PER_S, n_ops / rate
            row = {"ms": time_ms(lambda: kernel(*args, **kw), dev),
                   "plain_ms": time_ms(lambda: plain(*args, **kw), dev, n=3,
                                       warmup=1),
                   "bound": (max(tb, to) * 1e3,
                             "bytes" if tb >= to else "operations"),
                   "library_ms": None, "bytes": n_bytes, "ops": n_ops,
                   "shape": f"{label} "
                            + " ".join(f"{k}={v}" for k, v in s.items())
                            + f" {str(dtype).split('.')[-1]}"}
            if name == "flash_attention":
                row["library_ms"] = time_ms(_flash_library(args, kw), dev)
                if cases is None:   # full size: the card's run alone
                    row["qwen2_7b_prefill"] = flash_dense_timing(dev, gen)
            timings[name] = row
            del args, got, want
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        log(f"  {name:15s} {chk.cases} cases vs plain: max_abs_err "
            f"{chk.max_err:.3g}, max bf16 ulps {chk.max_ulps}")
        r = timings[name]
        log(f"  {name:15s} kernel {r['ms']:.6f} ms  plain "
            f"{r['plain_ms']:.4f} ms  library "
            f"{'-' if r['library_ms'] is None else '%.4f' % r['library_ms']}"
            f" ms  bound {r['bound'][0]:.6f} ms ({r['bound'][1]}; "
            f"{r['bytes'] / 1e6:.1f} MB, {r['ops'] / 1e9:.2f} Gop; "
            f"{r['bound'][0] / r['ms']:.1%} of the kernel's time)  "
            f"[{r['shape']}]")
    return checks, timings


#: flash_attention's backward (and its forward's lse) against their plain
#: versions: the training shape (qwen2-7b's attention at train_4k's
#: length: Hq 32 over Hkv 4, D 128, causal), recurrentgemma-9b's training
#: shape (FLASH_BWD_D256: S 4,096, D 256, window 2,048, GQA 16/1) and its
#: shape at S 3,072, then FLASH_CASES' decode shape and edges (sq_valid
#: and sk_valid, rows without keys, D 16 and 32, rep 1, float32).  The
#: first is timed, and FLASH_BWD_D256 wherever it is among the cases.
FLASH_BWD_D256 = "rg9b train-4k"
FLASH_BWD_CASES = (
    ("train-4k", dict(B=1, Hq=32, Hkv=4, Sq=4096, Sk=4096, D=128,
                      causal=True, window=None), torch.bfloat16),
    (FLASH_BWD_D256, dict(B=1, Hq=16, Hkv=1, Sq=4096, Sk=4096, D=256,
                          causal=True, window=2048), torch.bfloat16),
    ("rg9b S=3072", dict(B=1, Hq=16, Hkv=1, Sq=3072, Sk=3072, D=256,
                         causal=True, window=2048), torch.bfloat16),
) + FLASH_CASES[1:]
#: Edges of the bf16 tensor-core backward, at D <= 128 (128-key and
#: 128-row blocks of two 64-wide warpgroups) and at D 256 (64-key and
#: 64-row blocks, the columns split between the warpgroups): GQA 8 / 16
#: with a window across the key blocks and 64-row tiles, Sq < Sk
#: end-aligned with ragged tiles and sk_valid < Sk, rep 1 without the
#: causal band (no partials), rows that see no key (D 16 padded to 64,
#: and D 256).
FLASH_BWD_BF16_EDGE_CASES = (
    ("bwd bf16 rep8 window 100", dict(B=1, Hq=8, Hkv=1, Sq=300, Sk=300,
                                      D=128, causal=True, window=100),
     torch.bfloat16),
    ("bwd bf16 Sq<Sk sk_valid", dict(B=2, Hq=4, Hkv=2, Sq=100, Sk=260,
                                     D=128, causal=True, window=None,
                                     sk_valid=230), torch.bfloat16),
    ("bwd bf16 D64 rep1 full", dict(B=2, Hq=3, Hkv=3, Sq=70, Sk=70, D=64,
                                    causal=False, window=None),
     torch.bfloat16),
    ("bwd bf16 D16 rows without keys", dict(B=1, Hq=4, Hkv=2, Sq=90,
                                            Sk=150, D=16, causal=True,
                                            window=None, sq_valid=80,
                                            sk_valid=50), torch.bfloat16),
    ("bwd bf16 D256 rep16 window 100", dict(B=1, Hq=16, Hkv=1, Sq=300,
                                            Sk=300, D=256, causal=True,
                                            window=100), torch.bfloat16),
    ("bwd bf16 D256 Sq<Sk sk_valid", dict(B=2, Hq=4, Hkv=2, Sq=100,
                                          Sk=260, D=256, causal=True,
                                          window=None, sk_valid=230),
     torch.bfloat16),
    ("bwd bf16 D256 rep1 full", dict(B=2, Hq=3, Hkv=3, Sq=70, Sk=70,
                                     D=256, causal=False, window=None),
     torch.bfloat16),
    ("bwd bf16 D256 rows without keys", dict(B=1, Hq=4, Hkv=2, Sq=90,
                                             Sk=150, D=256, causal=True,
                                             window=None, sq_valid=80,
                                             sk_valid=50), torch.bfloat16),
)
FLASH_BWD_CASES = FLASH_BWD_CASES + FLASH_BWD_BF16_EDGE_CASES
#: Relative L2 allowed between the backward kernel's dq, dk, dv and the
#: plain version's, by dtype: the same float32 sums in another order, on
#: float32 or on bfloat16 outputs (one bf16 rounding is 2^-9 of a value).
FLASH_BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
#: The same rule for rglru's and rwkv6's backwards, gradient by gradient.
RECURRENT_BWD_RTOL = FLASH_BWD_RTOL


def flash_bwd_work(s, dtype, dev) -> tuple[float, float, float]:
    """(bytes, operations, peak rate) of one backward call: q, k, v, o,
    do and lse read once, dq, dk, dv written once; 10 D flops per visible
    (q, k) pair (S and dP recomputed, dV, dK and dQ), 2.5x the
    forward's."""
    _, ops, rate = flash_work(s, dtype, dev)
    el = torch.finfo(dtype).bits // 8
    rows = s["B"] * s["Hq"] * s["Sq"]
    kv_rows = s["B"] * s["Hkv"] * s["Sk"]
    n_bytes = el * s["D"] * 4 * (rows + kv_rows) + 4 * rows
    return n_bytes, 2.5 * ops, rate


def _sdpa_train(args, kw, dout):
    """One PyTorch call of the same function as the forward and backward
    together: scaled dot-product attention with the same boolean mask,
    forward and backward through autograd (kv heads repeated first,
    outside the timing), and the name of the backend PyTorch picks for
    it (``torch._fused_sdp_choice`` on these inputs).  A yardstick only;
    the port never calls it.  Returns (run, backend)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import attention_mask
    q, k, v = args
    rep = q.shape[1] // k.shape[1]
    q = q.detach().requires_grad_()
    kk = k.repeat_interleave(rep, 1).detach().requires_grad_()
    vv = v.repeat_interleave(rep, 1).detach().requires_grad_()
    Sq, Sk = q.shape[2], k.shape[2]
    mask = attention_mask(Sq, Sk, causal=kw["causal"], window=kw["window"],
                          sq_valid=kw["sq_valid"] or Sq,
                          sk_valid=kw["sk_valid"] or Sk, device=q.device)

    def run():
        out = F.scaled_dot_product_attention(q, kk, vv, attn_mask=mask)
        torch.autograd.grad(out, (q, kk, vv), dout)
    from torch.nn.attention import SDPBackend
    return run, SDPBackend(torch._fused_sdp_choice(q, kk, vv, mask)).name


def _plain_causal(s) -> bool:
    """Whether the case's mask is SDPA's is_causal mask: causal, no
    window, every row and key valid, Sq = Sk."""
    return (s["causal"] and s["window"] is None and s["Sq"] == s["Sk"]
            and s.get("sq_valid") in (None, s["Sq"])
            and s.get("sk_valid") in (None, s["Sk"]))


def _sdpa_causal_train(args, dout):
    """SDPA's forward and backward with is_causal and enable_gqa (no
    mask, kv heads not repeated): the backends that take no mask.  A
    yardstick only; the port never calls it."""
    import torch.nn.functional as F
    q, k, v = (t.detach().requires_grad_() for t in args)

    def run():
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             enable_gqa=True)
        torch.autograd.grad(out, (q, k, v), dout)
    return run


def _sdpa_causal(args):
    """SDPA's forward with is_causal and enable_gqa; a yardstick only."""
    import torch.nn.functional as F
    q, k, v = args
    return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)


#: The backward's launches, by a piece of their kernels' names.
BWD_LAUNCHES = (("delta", "delta_kernel"), ("dkdv", "dkdv_kernel"),
                ("rep sum", "rep_sum_kernel"), ("dq", "dq_kernel"))


def bwd_kernels(top_device: list, launches=BWD_LAUNCHES) -> dict:
    """{launch: (device ms, launches)} of the backward's ``launches``
    ((label, a piece of the kernel's name)) in a profile's ``top_device``
    (profile_device), per profiled unit."""
    out = {}
    for t in top_device:
        for label, piece in launches:
            if piece in t["name"]:
                ms, k = out.get(label, (0.0, 0.0))
                out[label] = (ms + t["ms_per_wave"], k + t["per_wave"])
    return out


def bwd_split(fn, n=5, launches=BWD_LAUNCHES) -> tuple[dict, dict, float]:
    """({launch: device ms of one launch, the mean over those the profile
    holds}, {launch: launches it holds}, device-busy ms a call) of a
    backward's ``launches`` (flash_attention_backward's by default) over
    ``n`` calls of ``fn`` under torch.profiler: each call makes each
    launch once (the rep sum where Hq > Hkv).  Late in a long process
    the profiler on the card has dropped a window's events (a launch held
    fewer than ``n`` times, or none): such a window is taken again, up to
    three windows, and the one holding the most launches kept."""
    from repro_torch.launch.wave_profile import profile_device
    best = None
    for _ in range(3):
        pr = profile_device(lambda: [fn() for _ in range(n)], n, top=12)
        seen = bwd_kernels(pr["top_device"], launches)
        held = sum(c for _, c in seen.values())
        if best is None or held > best[0]:
            best = (held, seen, pr["device_busy_ms_per_wave"])
        if seen and all(round(c * n) == n for _, c in seen.values()):
            break
    _, seen, busy = best
    return ({k: ms / c for k, (ms, c) in seen.items()},
            {k: c * n for k, (_, c) in seen.items()}, busy)


def _bwd_timing(label, s, dtype, args, kw, bargs, dout, dev):
    """One timed backward case: the forward with lse, the backward (and
    its launches' split), the plain backward, the bound, and SDPA's
    forward + backward (the same mask, the backend that ran; and
    is_causal with enable_gqa where the mask is that one).  Returns the
    timing row."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_backward_plain,
        flash_attention_forward)
    fkw = dict(kw, scale=None)
    fwd = flash_attention_forward
    fb, fo, rate = flash_work(s, dtype, dev)
    bb, bo, _ = flash_bwd_work(s, dtype, dev)

    def this():
        return flash_attention_backward(*bargs, **kw)
    f_ms = time_ms(lambda: fwd(*args, with_lse=True, **fkw), dev, n=10,
                   warmup=2)
    b_ms = time_ms(this, dev, n=10, warmup=2)
    sdpa, backend = _sdpa_train(args, kw, dout)
    row = {
        "ms": b_ms,
        "plain_ms": time_ms(
            lambda: flash_attention_backward_plain(*bargs, **kw), dev, n=3,
            warmup=1),
        "bound": (max(bb / PEAK_BYTES_PER_S, bo / rate) * 1e3,
                  "bytes" if bb / PEAK_BYTES_PER_S >= bo / rate
                  else "operations"),
        "library_ms": time_ms(sdpa, dev, n=10, warmup=2),
        "library_backend": backend,
        "forward_lse_ms": f_ms,
        "forward_ms": time_ms(lambda: fwd(*args, with_lse=False, **fkw),
                              dev, n=10, warmup=2),
        "forward_bound_ms": max(fb / PEAK_BYTES_PER_S, fo / rate) * 1e3,
        "split_ms": {}, "split_launches": {}, "busy_ms": None,
        "library_causal_ms": (time_ms(_sdpa_causal_train(args, dout), dev,
                                      n=10, warmup=2)
                              if _plain_causal(s) else None),
        "bytes": bb, "ops": bo,
        "shape": f"{label} " + " ".join(f"{k}={v}" for k, v in s.items())
                 + f" {str(dtype).split('.')[-1]}"}
    if dev.type == "cuda":
        row["split_ms"], row["split_launches"], row["busy_ms"] = bwd_split(
            this)
    log(f"  flash_attention backward split (profiler, ms a launch): "
        + ", ".join(f"{k} {v:.6f} (x{row['split_launches'][k]:.0f})"
                    for k, v in row["split_ms"].items())
        + f"; device-busy {row['busy_ms']} ms a call"
        + f"; SDPA is_causal enable_gqa forward + backward "
        f"{row['library_causal_ms']} ms; SDPA with the mask ran "
        f"{backend}")
    log(f"  flash_attention forward+lse {f_ms:.6f} ms (without "
        f"lse {row['forward_ms']:.6f} ms), bound "
        f"{row['forward_bound_ms']:.6f} ms; backward {b_ms:.6f} ms,"
        f" bound {row['bound'][0]:.6f} ms ({row['bound'][1]}; "
        f"{bo / 1e9:.2f} Gop, {row['bound'][0] / b_ms:.1%} of the "
        f"kernel's time); plain backward {row['plain_ms']:.4f} ms; "
        f"SDPA forward + backward {row['library_ms']:.4f} ms "
        f"against {f_ms + b_ms:.4f} ms  [{row['shape']}]")
    return row


def flash_backward_phase(dev, seed=23, cases=None):
    """flash_attention_backward against flash_attention_backward_plain on
    the same inputs (q, k, v, the kernel forward's output and lse, and a
    random dO), dq, dk, dv within FLASH_BWD_RTOL in relative L2, over
    FLASH_BWD_CASES (``cases`` replaces them: a rehearsal on the CPU at
    small shapes); and the forward's lse against the plain log-sum-exp
    (-inf on the same rows, finite ones within 1e-4 + 1e-5 |lse|), its
    output equal bit for bit to the forward without lse; a second call of
    the backward gives the same bits.  The first case and FLASH_BWD_D256
    are timed (_bwd_timing).  Returns (summary, the first case's timing
    row, with FLASH_BWD_D256's under "d256" where it ran).
    """
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_backward_plain,
        flash_attention_forward, flash_attention_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    worst = {"dq_dk_dv_rel_l2": 0.0, "lse_max_abs_err": 0.0,
             "max_abs_err": 0.0, "cases": 0}
    row = d256 = None
    for i, (label, s, dtype) in enumerate(cases or FLASH_BWD_CASES):
        args, kw = flash_inputs(s, dtype, dev, gen)
        fkw = dict(kw, scale=None)
        fwd = flash_attention_forward
        out, lse = fwd(*args, with_lse=True, **fkw)
        plain_out, plain_lse = flash_attention_plain(*args, with_lse=True,
                                                     **kw)
        if not torch.equal(out, fwd(*args, with_lse=False, **fkw)):
            raise AssertionError(f"flash_attention {label}: the output "
                                 f"with lse differs from the one without")
        if not torch.equal(torch.isinf(lse), torch.isinf(plain_lse)):
            raise AssertionError(f"flash_attention {label}: lse is -inf on "
                                 f"other rows than the plain version's")
        fin = torch.isfinite(plain_lse)
        lse_err = float((lse[fin] - plain_lse[fin]).abs().max()) \
            if bool(fin.any()) else 0.0
        if not bool(((lse[fin] - plain_lse[fin]).abs()
                     <= 1e-4 + 1e-5 * plain_lse[fin].abs()).all()):
            raise AssertionError(f"flash_attention {label}: lse off by "
                                 f"{lse_err}")
        dout = _randn(out.shape, dev, gen, 1.0, dtype)
        bargs = (*args, out, lse, dout)
        got = flash_attention_backward(*bargs, **kw)
        again = flash_attention_backward(*bargs, **kw)
        want = flash_attention_backward_plain(*bargs, **kw)
        _sync(dev)
        for name, a, b in zip(("dq", "dk", "dv"), got, again):
            if not torch.equal(_bits(a), _bits(b)):
                raise AssertionError(f"flash_attention_backward {label} "
                                     f"{name}: two calls differ")
        errs = []
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"{label} {name}: {a.dtype}"
                                     f"{tuple(a.shape)} vs {b.dtype}"
                                     f"{tuple(b.shape)}")
            if not bool(torch.isfinite(a.float()).all()):
                raise AssertionError(f"{label} {name}: not finite")
            errs.append(rel_l2(a, b))
            worst["max_abs_err"] = max(worst["max_abs_err"], float(
                (a.float() - b.float()).abs().max()) if a.numel() else 0.0)
        log(f"    flash_attention_backward {label} "
            f"{str(dtype).split('.')[-1]}: rel L2 dq {errs[0]:.3g} dk "
            f"{errs[1]:.3g} dv {errs[2]:.3g}; lse max abs err "
            f"{lse_err:.3g}")
        if max(errs) > FLASH_BWD_RTOL[dtype]:
            raise AssertionError(f"flash_attention_backward {label}: "
                                 f"relative L2 {errs} above "
                                 f"{FLASH_BWD_RTOL[dtype]}")
        worst["dq_dk_dv_rel_l2"] = max(worst["dq_dk_dv_rel_l2"], *errs)
        worst["lse_max_abs_err"] = max(worst["lse_max_abs_err"], lse_err)
        worst["cases"] += 1
        del got, again, want, plain_out, plain_lse
        if i == 0:
            row = _bwd_timing(label, s, dtype, args, kw, bargs, dout, dev)
        elif label == FLASH_BWD_D256:
            d256 = _bwd_timing(label, s, dtype, args, kw, bargs, dout, dev)
        del args, out, lse, dout, bargs
    if row is not None and d256 is not None:
        row["d256"] = d256
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"  flash_attention_backward {worst['cases']} cases vs plain: "
        f"max rel L2 {worst['dq_dk_dv_rel_l2']:.3g}, max abs err "
        f"{worst['max_abs_err']:.3g}; lse max abs err "
        f"{worst['lse_max_abs_err']:.3g}")
    return worst, row


#: The recurrences' backwards: kernels of the port's own, with no TPU
#: kernel; the JAX package differentiates the calls below by autodiff of
#: their scans.
RECURRENT_BWD_META = {
    "rglru_backward": ("src/repro_torch/csrc/rglru_bwd.cu",
                       "src/repro/models/recurrent.py:62"),
    "rwkv6_backward": ("src/repro_torch/csrc/rwkv6_bwd.cu",
                       "src/repro/models/recurrent.py:129"),
}
#: rglru_backward's cases: (label, shape, dtype), h0 and dh_last given
#: unless "h0" / "last" is False.  The first is recurrentgemma-9b's
#: training shape (one microbatch), timed; then a = 1 exactly on a third
#: of the elements and log_a <= -20 on another ("edge"), S = 1, 63, 65 and
#: 1,000, D off the 64-channel block with 16-byte rows (4,104) and without
#: (300: element-wise copies), fewer channels than a block, float32.
RGLRU_BWD_CASES = (
    ("rg9b-train", dict(B=1, S=4096, D=4096), torch.bfloat16),
    ("a=1 and log_a<=-20", dict(B=2, S=300, D=512, log_a="edge"),
     torch.bfloat16),
    ("S=1", dict(B=2, S=1, D=256), torch.bfloat16),
    ("S=63 no h0", dict(B=2, S=63, D=256, h0=False), torch.bfloat16),
    ("S=65 no dh_last", dict(B=2, S=65, D=256, last=False), torch.bfloat16),
    ("S=1000 f32", dict(B=2, S=1000, D=512), torch.float32),
    ("D=4104", dict(B=1, S=130, D=4104), torch.bfloat16),
    ("D=300 neither", dict(B=3, S=200, D=300, h0=False, last=False),
     torch.bfloat16),
    ("D=300 f32 edge", dict(B=2, S=70, D=300, log_a="edge"), torch.float32),
    ("B*D<block", dict(B=1, S=77, D=40), torch.float32),
)
#: rwkv6_backward's cases, s0 and ds_last given unless "s0" / "last" is
#: False.  The first is rwkv6-3b's training step's shape (one microbatch,
#: the model's decay, H 48: the model pads its 40 wkv heads to
#: cfg.n_heads), the second the same at the raw 40 heads, both timed
#: (RWKV_BWD_TIMED); then w = 0 and 1 exactly, S = 1, 63, 64, 65, 128,
#: 1,000 and 4,097 (a chunk of one token), w at 1.9e-24 on a third of the
#: steps, Dk 16, 32 and 128 with Dv = Dk and Dv != Dk, bf16 and float32:
#: both routes (rwkv6.route), every tile count of the chunked one.
RWKV_BWD_CASES = (
    ("rwkv6-3b-train", dict(B=1, H=48, S=4096, Dk=64, Dv=64,
                            decay="model"), torch.bfloat16),
    ("rwkv6-3b-train H40", dict(B=1, H=40, S=4096, Dk=64, Dv=64,
                                decay="model"), torch.bfloat16),
    ("S=64", dict(B=2, H=3, S=64, Dk=64, Dv=64, decay="model"),
     torch.bfloat16),
    ("S=128", dict(B=1, H=4, S=128, Dk=64, Dv=64, decay="model"),
     torch.bfloat16),
    ("w 1e-24", dict(B=2, H=2, S=200, Dk=64, Dv=64, decay="1e-24"),
     torch.bfloat16),
    ("S=4097", dict(B=1, H=4, S=4097, Dk=64, Dv=64, decay="model"),
     torch.bfloat16),
    ("w 0 and 1", dict(B=2, H=4, S=300, Dk=64, Dv=64, decay="edge"),
     torch.bfloat16),
    ("S=1", dict(B=2, H=4, S=1, Dk=64, Dv=64), torch.float32),
    ("S=63 no s0", dict(B=2, H=4, S=63, Dk=64, Dv=64, decay="model",
                        s0=False), torch.bfloat16),
    ("S=64 f32", dict(B=1, H=3, S=64, Dk=64, Dv=64, decay="edge"),
     torch.float32),
    ("S=65 no ds_last", dict(B=2, H=2, S=65, Dk=64, Dv=64, decay="model",
                             last=False), torch.bfloat16),
    ("S=1000", dict(B=1, H=4, S=1000, Dk=64, Dv=64, decay="model"),
     torch.bfloat16),
    ("Dk16", dict(B=2, H=3, S=100, Dk=16, Dv=16, decay="edge"),
     torch.float32),
    ("Dk16 Dv8", dict(B=1, H=2, S=40, Dk=16, Dv=8), torch.bfloat16),
    ("Dk32 Dv48", dict(B=1, H=2, S=130, Dk=32, Dv=48, decay="model"),
     torch.bfloat16),
    ("Dk128 Dv64 neither", dict(B=1, H=2, S=150, Dk=128, Dv=64,
                                decay="model", s0=False, last=False),
     torch.float32),
    ("Dk128 Dv128", dict(B=1, H=2, S=70, Dk=128, Dv=128, decay="edge"),
     torch.bfloat16),
)


def rglru_bwd_inputs(s, dtype, dev, gen):
    """(log_a, x, h0 or None, dh, dh_last or None)."""
    (log_a, x, h0), _ = rglru_inputs(s, dtype, dev, gen)
    dh = _randn(x.shape, dev, gen, 1.0, dtype)
    dh_last = _randn(h0.shape, dev, gen)
    return (log_a, x, h0 if s.get("h0", True) else None, dh,
            dh_last if s.get("last", True) else None)


def rwkv_bwd_inputs(s, dtype, dev, gen):
    """(r, k, v, w, u, s0 or None, dout, ds_last or None)."""
    (r, k, v, w, u, s0), _ = rwkv_inputs(s, dtype, dev, gen)
    dout = _randn(v.shape, dev, gen, 1.0, dtype)
    ds_last = _randn(s0.shape, dev, gen)
    return (r, k, v, w, u, s0 if s.get("s0", True) else None, dout,
            ds_last if s.get("last", True) else None)


def rglru_bwd_work(s, dtype, dev):
    """(bytes, operations, peak rate): log_a, x and dh read once, dlog_a
    and dx written once (h0, dh_last, dh0 as given); an exp, a sqrt, a
    division and 12 flops an element (h recomputed, the g chain, dx and
    dlog_a)."""
    n = s["B"] * s["S"] * s["D"]
    el = torch.finfo(dtype).bits // 8
    bd = s["B"] * s["D"]
    n_bytes = (n * (8 + 3 * el) + 4 * bd * (int(s.get("h0", True)) * 2
                                            + int(s.get("last", True))))
    return n_bytes, 15.0 * n, PEAK_OPS_PER_S


def rwkv_bwd_work(s, dtype, dev):
    """(bytes, operations, peak rate): r, k, v, w, dout (u, s0, ds_last)
    read once, dr, dk, dv, dw (du, ds0) written once; 14 flops a state
    element and token (the state recomputed, w S + k v; dS, w dS +
    r dout; the contractions dS v, dS * S_{t-1}, S_{t-1} dout and
    dS^T k)."""
    B, H, S, Dk, Dv = s["B"], s["H"], s["S"], s["Dk"], s["Dv"]
    el = torch.finfo(dtype).bits // 8
    state = 4 * B * H * Dk * Dv
    n_bytes = (B * H * S * (el * (4 * Dk + 3 * Dv) + 8 * Dk)
               + 8 * H * Dk + state * (2 * int(s.get("s0", True))
                                       + int(s.get("last", True))))
    return n_bytes, 14.0 * B * H * S * Dk * Dv, PEAK_OPS_PER_S


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    as_int = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.contiguous().view(as_int),
                       b.contiguous().view(as_int))


def _grad_gate(what, names, got, want, rtol) -> tuple[dict, float]:
    """Raise unless every gradient of ``got`` meets ``want``: the same
    dtype, shape and None-ness; NaN and +-inf at the same places (rglru's
    dlog_a at a = 1); the finite values within relative L2 ``rtol`` by
    dtype.  Returns ({gradient: relative L2, or "bits" where
    bit-identical}, max abs error)."""
    out, worst = {}, 0.0
    for name, a, b in zip(names, got, want):
        if a is None or b is None:
            if (a is None) != (b is None):
                raise AssertionError(f"{what} {name}: {a is None} vs "
                                     f"{b is None} for None")
            continue
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{what} {name}: {a.dtype}"
                                 f"{tuple(a.shape)} vs {b.dtype}"
                                 f"{tuple(b.shape)}")
        af, bf = a.float(), b.float()
        fin = torch.isfinite(bf)
        if not (torch.equal(torch.isnan(af), torch.isnan(bf))
                and torch.equal(torch.where(torch.isinf(af), af, 0.0),
                                torch.where(torch.isinf(bf), bf, 0.0))):
            raise AssertionError(f"{what} {name}: NaN or inf elsewhere "
                                 f"than the plain version's")
        err = rel_l2(af[fin], bf[fin]) if bool(fin.any()) else 0.0
        if a.numel():
            worst = max(worst, float((af[fin] - bf[fin]).abs().max())
                        if bool(fin.any()) else 0.0)
        if err > rtol[a.dtype]:
            raise AssertionError(f"{what} {name}: relative L2 {err} above "
                                 f"{rtol[a.dtype]}")
        out[name] = "bits" if _same_bits(a, b) else err
    return out, worst


#: rwkv6_backward's cases timed beside the first case (the step's H 48):
#: the raw head count, timed by every PR before the chunked route.
RWKV_BWD_TIMED = ("rwkv6-3b-train H40",)
#: rwkv6_backward's launches in a profile, by a piece of their kernels'
#: names: the chunked route's chains, chunk pass, tile combine and du sum,
#: and the recurrent route's kernel.
RWKV_BWD_LAUNCHES = (("chains", "rwkv6_bwd_chain_kernel"),
                     ("chunk pass", "rwkv6_bwd_chunk_kernel"),
                     ("combine", "rwkv6_bwd_combine_kernel"),
                     ("du sum", "du_sum_kernel"),
                     ("recurrent", "rwkv6_bwd_kernel"))


def parent_rwkv6_bwd(fns, r, k, v, w, u, s0, dout, ds_last=None):
    """A call of the parent's build of rwkv6_backward (``fns``: its C
    entries repro_rwkv6_bwd and repro_rwkv6_bwd_scratch, bound with
    PARENT_KERNELS' signatures): the recurrent kernel, outputs and
    scratch as the parent's wrapper made them."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import DTYPE_CODES
    B, H, S, Dk = r.shape
    Dv = v.shape[-1]
    dev = r.device
    dr, dk, dv = torch.empty_like(r), torch.empty_like(k), torch.empty_like(v)
    dw = torch.empty((B, H, S, Dk), dtype=torch.float32, device=dev)
    du = torch.empty((H, Dk), dtype=torch.float32, device=dev)
    ds0 = (None if s0 is None
           else torch.empty((B, H, Dk, Dv), dtype=torch.float32, device=dev))
    n = ctypes.c_longlong(0)
    code = DTYPE_CODES[r.dtype]
    build.raise_on_error("parent rwkv6_backward", fns["rwkv6_bwd_scratch"](
        B, H, S, Dk, Dv, code, ctypes.byref(n)))
    scratch = torch.empty((n.value,), dtype=torch.float32, device=dev)
    build.raise_on_error("parent rwkv6_backward", fns["rwkv6_bwd"](
        *(build.ptr(t) for t in (r, k, v, w, u, s0, dout, ds_last, dr, dk,
                                 dv, dw, du, ds0, scratch)),
        B, H, S, Dk, Dv, code, build.stream(dev)))
    return dr, dk, dv, dw, du, ds0


def _rec_bwd_timing(name, label, s, dtype, kernel, plain, args, work, dev,
                    parent=None, split=False) -> dict:
    """One timed recurrent backward case: the kernel, its plain version,
    the bound; for rwkv6_backward on the card with ``split`` the
    per-launch split (RWKV_BWD_LAUNCHES) and, with ``parent`` (the
    --parent C entries), the parent's build on the same inputs in turns
    parent, this, this, parent.  Returns the timing row."""
    n_bytes, n_ops, rate = work(s, dtype, dev)
    tb, to = n_bytes / PEAK_BYTES_PER_S, n_ops / rate

    def this():
        return kernel(*args)
    row = {"ms": time_ms(this, dev, n=10, warmup=2),
           "plain_ms": time_ms(lambda: plain(*args), dev, n=2, warmup=1),
           "bound": (max(tb, to) * 1e3, "bytes" if tb >= to
                     else "operations"),
           "library_ms": None, "bytes": n_bytes, "ops": n_ops,
           "split_ms": {}, "split_launches": {}, "busy_ms": None,
           "parent_ms": None,
           "shape": f"{label} " + " ".join(f"{k}={v}" for k, v in s.items())
                    + f" {str(dtype).split('.')[-1]}"}
    if split and name == "rwkv6_backward" and dev.type == "cuda":
        row["split_ms"], row["split_launches"], row["busy_ms"] = bwd_split(
            this, launches=RWKV_BWD_LAUNCHES)
        log(f"  rwkv6_backward split (profiler, ms a launch): "
            + ", ".join(f"{k} {v:.6f} (x{row['split_launches'][k]:.0f})"
                        for k, v in row["split_ms"].items())
            + f"; device-busy {row['busy_ms']} ms a call  [{label}]")
    if name == "rwkv6_backward" and parent is not None:
        def prev():
            return parent_rwkv6_bwd(parent, *args)
        want = plain(*args)
        err = max(rel_l2(a, b) for a, b in zip(prev(), want)
                  if a is not None)
        ts = {"parent": [], "this": []}
        for who in ("parent", "this", "this", "parent"):
            ts[who].append(time_ms(prev if who == "parent" else this, dev,
                                   n=10, warmup=2))
        row["parent_ms"] = statistics.mean(ts["parent"])
        row["this_turns_ms"] = ts["this"]
        log(f"  {label} in turns: parent {ts['parent']} ms, this build "
            f"{ts['this']} ms (the parent's rel L2 to plain {err:.3g})")
    log(f"  {name:15s} kernel {row['ms']:.6f} ms  plain "
        f"{row['plain_ms']:.4f} ms  bound {row['bound'][0]:.6f} ms "
        f"({row['bound'][1]}; {n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.2f} "
        f"Gop; {row['bound'][0] / row['ms']:.1%} of the kernel's time)  "
        f"[{row['shape']}]")
    return row


def recurrent_backward_phase(dev, seed=25, cases=None, parent=None):
    """rglru_backward and rwkv6_backward against their plain versions on
    the same inputs (random forward inputs and output gradients) over
    RGLRU_BWD_CASES and RWKV_BWD_CASES (``cases``, {name: cases}, replaces
    them: a rehearsal on the CPU at small shapes), every gradient within
    RECURRENT_BWD_RTOL by dtype (_grad_gate), a second call giving the
    same bits; the first case of each, and RWKV_BWD_TIMED, timed beside
    its bound and its plain version (_rec_bwd_timing: the per-launch
    split at the first case; ``parent``, the --parent C entries, times
    the parent's rwkv6_backward at each).
    Returns ({name: summary, with each route's cases and bit-identical
    gradients under "by_route"}, {name: the first case's timing row, with
    RWKV_BWD_TIMED's under their labels})."""
    from repro_torch.kernels.rglru import rglru_backward, rglru_backward_plain
    from repro_torch.kernels.rwkv6 import (route, rwkv6_backward,
                                           rwkv6_backward_plain)
    table = {
        "rglru_backward": (rglru_backward, rglru_backward_plain,
                           RGLRU_BWD_CASES, rglru_bwd_inputs, rglru_bwd_work,
                           ("dlog_a", "dx", "dh0")),
        "rwkv6_backward": (rwkv6_backward, rwkv6_backward_plain,
                           RWKV_BWD_CASES, rwkv_bwd_inputs, rwkv_bwd_work,
                           ("dr", "dk", "dv", "dw", "du", "ds0")),
    }
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    summary, timings = {}, {}
    for name, (kernel, plain, default, inputs, work, names) in table.items():
        sm = summary[name] = {"cases": 0, "max_rel_l2": 0.0,
                              "max_abs_err": 0.0,
                              "bit_identical": {g: True for g in names},
                              "by_route": {}}
        for i, (label, s, dtype) in enumerate((cases or {}).get(name,
                                                                default)):
            rt = (route(dtype, s["S"]) if name == "rwkv6_backward"
                  else "recurrent")
            br = sm["by_route"].setdefault(rt, {
                "cases": 0, "bit_identical": {g: True for g in names}})
            args = inputs(s, dtype, dev, gen)
            got, again = kernel(*args), kernel(*args)
            want = plain(*args)
            _sync(dev)
            for g, a, b in zip(names, got, again):
                if a is not None and not _same_bits(a, b):
                    raise AssertionError(f"{name} {label} {g}: two calls "
                                         f"differ")
            errs, worst = _grad_gate(f"{name} {label}", names, got, want,
                                     RECURRENT_BWD_RTOL)
            for g in names:
                if g in errs and errs[g] != "bits":
                    sm["bit_identical"][g] = br["bit_identical"][g] = False
                    sm["max_rel_l2"] = max(sm["max_rel_l2"], errs[g])
            sm["max_abs_err"] = max(sm["max_abs_err"], worst)
            sm["cases"] += 1
            br["cases"] += 1
            log(f"    {name} {label} {str(dtype).split('.')[-1]} ({rt}): "
                + ", ".join(f"{g} " + (v if v == "bits" else f"{v:.3g}")
                            for g, v in errs.items())
                + f"; max abs err {worst:.3g}")
            del got, again, want
            if i == 0 or (name == "rwkv6_backward"
                          and label in RWKV_BWD_TIMED):
                row = _rec_bwd_timing(name, label, s, dtype, kernel, plain,
                                      args, work, dev, parent, split=i == 0)
                if i == 0:
                    timings[name] = row
                else:
                    timings[name][label] = row
            del args
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        log(f"  {name}: {sm['cases']} cases vs plain: max rel L2 "
            f"{sm['max_rel_l2']:.3g}, max abs err {sm['max_abs_err']:.3g}; "
            f"bit-identical in every case, by route: "
            + "; ".join(f"{r} ({b['cases']} cases) "
                        f"{[g for g, v in b['bit_identical'].items() if v]}"
                        for r, b in sm["by_route"].items()))
    return summary, timings


def _lm_profiles(cfg, params, prompt, first, s_cache, n_decode=4):
    """torch.profiler over one prefill and ``n_decode`` decode steps of the
    kernel route: wall and device-busy ms, idle share, device events and
    the top kernels, per prefill and per decode step."""
    from repro_torch.launch.wave_profile import profile_device
    from repro_torch.models import steps
    prefill = steps.build_prefill_step(cfg, s_cache)
    decode = steps.build_decode_step(cfg)
    state = {}

    def run_prefill():
        state["cache"], _ = prefill(params, {"tokens": prompt})

    def run_decode():
        for i in range(n_decode):
            _, state["cache"] = decode(params, state["cache"], first,
                                       prompt.shape[1] + i)

    return {"prefill": profile_device(run_prefill, 1),
            "decode step": profile_device(run_decode, n_decode)}


def _route_logits(cfg, params, prompt, first, s_cache, plain):
    """Last-position logits of the prefill of ``prompt`` and of one
    decode step on ``first``, float32 on the host."""
    from repro_torch.models import steps
    cache, prefill = steps.build_prefill_step(cfg, s_cache, plain=plain)(
        params, {"tokens": prompt})
    decode, _ = steps.build_decode_step(cfg, plain=plain)(
        params, cache, first, prompt.shape[1])
    return prefill.float().cpu(), decode.float().cpu()


def _plain_greedy(cfg, params, prompt, gen):
    """The plain route's own greedy tokens [B, gen]: prefill, then gen - 1
    decode steps, each on the previous step's argmax."""
    from repro_torch.launch.serve import greedy
    from repro_torch.models import steps
    S = prompt.shape[1]
    cache, logits = steps.build_prefill_step(cfg, S + gen, plain=True)(
        params, {"tokens": prompt})
    decode = steps.build_decode_step(cfg, plain=True)
    out = [greedy(logits)[:, None]]
    for i in range(gen - 1):
        logits, cache = decode(params, cache, out[-1], S + i)
        out.append(greedy(logits)[:, None])
    return torch.cat(out, dim=1).cpu()


def greedy_agreement(a: torch.Tensor, b: torch.Tensor) -> list:
    """Per request, how many leading greedy tokens of ``a`` and ``b``
    [B, gen] are equal (up to the first difference)."""
    diff = (a != b).int()
    first = torch.where(diff.any(dim=1), diff.argmax(dim=1),
                        torch.full((a.shape[0],), a.shape[1]))
    return [int(x) for x in first]


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def lm_serve_path(dev, arch, seed=0, smoke=False, **traffic):
    """``arch`` at full width through repro_torch.launch.serve.serve, the
    kernels' launch counters set to 0 just before and read just after:
    flash_attention once per attention layer in the prefill and never in
    decode, rglru and rwkv6 once per recurrent layer in the prefill and
    in every decode step, nothing else.  Then the same weights and prompt
    through the plain route (prefill and one decode step on the kernel
    route's first token), and both routes on the float32 model of the
    same weights.  Checked: the float32 routes' last-position logits
    within relative L2 LM_ROUTE_RTOL, and the bf16 kernel route at most
    twice as far from the float32 model as the bf16 plain route (plus
    LM_ROUTE_RTOL): both round the same model to bf16, where a wrong
    kernel is off by the logits' whole scale.  The bf16 routes' distance
    to each other is reported against LM_ROUTE_RTOL, not checked: bf16
    rounding of the residual stream turns any last-bit difference of a
    kernel's output into 1-ulp changes of many of the next residual's
    elements, layer after layer, so two correct evaluations of the bf16
    model can differ by more than that bound.  The bf16 plain route also
    decodes its own ``gen`` greedy tokens, and the row reports how many of
    each request's equal the kernel route's (``plain_greedy_agree``), for
    the same reason unchecked.  ``smoke`` serves the smoke
    configuration (a rehearsal on the CPU, where nothing launches).
    Returns (summary row, launches of the served run)."""
    import gc
    from repro_torch import configs
    from repro_torch import kernels as K
    from repro_torch.data.pipeline import tokens as draw_tokens
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as model_mod
    from repro_torch.models.common import flatten, tree_map
    traffic = {**LM_TRAFFIC, **traffic}
    B, S, G = traffic["n_requests"], traffic["prompt_len"], traffic["gen"]
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    t0 = time.perf_counter()
    params = model_mod.init_params(cfg, seed, dev)
    n_params = sum(t.numel() for _, t in flatten(params))
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    prompt = draw_tokens(g, (B, S), cfg.vocab)
    _sync(dev)
    log(f"  {arch}: {n_params / 1e9:.3f} B parameters drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")

    K.reset_launches()
    res = serve(cfg, seed=seed, device=dev, tokens=prompt, params=params,
                **traffic)
    launches = K.launch_counts()
    types = cfg.layer_types()
    per_layer = {}          # the CPU launches no kernel
    if dev.type == "cuda":
        per_layer = {"flash_attention": types.count("attn"),
                     "rglru": types.count("rec"),
                     "rwkv6": types.count("rwkv")}
    want_prefill = {op: per_layer.get(op, 0) for op in K.WRAPPERS}
    want_decode = dict(want_prefill, flash_attention=0)
    if len(res.launches) != G or res.launches[0] != want_prefill:
        raise AssertionError(f"{arch} prefill launches {res.launches[0]}, "
                             f"want {want_prefill}")
    for i, step in enumerate(res.launches[1:]):
        if step != want_decode:
            raise AssertionError(f"{arch} decode step {i} launches {step}, "
                                 f"want {want_decode}")
    if launches != {op: want_prefill[op] + (G - 1) * want_decode[op]
                    for op in K.WRAPPERS}:
        raise AssertionError(f"{arch}: launches over the run {launches}")
    toks = torch.from_numpy(res.tokens)
    if (res.tokens.shape != (B, G) or int(toks.min()) < 0
            or int(toks.max()) >= cfg.vocab):
        raise AssertionError(f"{arch}: tokens {res.tokens.shape} out of "
                             f"range")
    for what, lg in (("prefill", res.prefill_logits),
                     ("decode", res.decode_logits)):
        if lg.shape != (B, cfg.vocab) or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{arch} {what} logits {lg.shape} not "
                                 f"finite")

    # Where the device time goes: one prefill and 4 decode steps of the
    # served (kernel) route under torch.profiler.
    first = toks[:, :1].to(dev)
    profiles = {}
    if dev.type == "cuda":
        profiles = _lm_profiles(cfg, params, prompt, first, S + G)

    # The plain route on the same weights, prompt and first token; then
    # both routes on the float32 model of the same weights.
    logits = {("bf16", "kernel"): (res.prefill_logits, res.decode_logits),
              ("bf16", "plain"): _route_logits(cfg, params, prompt, first,
                                               S + G, plain=True)}
    # Reported, not checked: bf16 rounding lets two correct routes part.
    agree = greedy_agreement(toks, _plain_greedy(cfg, params, prompt, G))
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    params = tree_map(lambda t: t.float(), params)
    for route in ("kernel", "plain"):
        logits[("f32", route)] = _route_logits(cfg32, params, prompt, first,
                                               S + G, plain=route == "plain")
    errs = {}
    for i, step in enumerate(("prefill", "decode")):
        def e(a, b):
            return rel_l2(logits[a][i], logits[b][i])
        errs[step] = {
            "bf16 kernel vs plain": e(("bf16", "kernel"), ("bf16", "plain")),
            "f32 kernel vs plain": e(("f32", "kernel"), ("f32", "plain")),
            "bf16 kernel vs f32 plain": e(("bf16", "kernel"),
                                          ("f32", "plain")),
            "bf16 plain vs f32 plain": e(("bf16", "plain"),
                                         ("f32", "plain"))}
    same_first = bool((logits[("bf16", "plain")][0].argmax(-1)
                       == toks[:, 0]).all())
    row = {"arch": arch, "params": n_params, "requests": B,
           "prompt_len": S, "gen": G,
           "prefill_ms": res.prefill_s * 1e3,
           "decode_tok_per_s": res.decode_tokens_per_s,
           "decode_ms_per_step": res.decode_s * 1e3 / max(G - 1, 1),
           "peak_gib": res.peak_bytes / 2**30,
           "route_rel_l2": errs, "plain_first_token_same": same_first,
           "plain_greedy_agree": agree,
           "bf16_routes_within_bound": all(
               v["bf16 kernel vs plain"] <= LM_ROUTE_RTOL
               for v in errs.values()),
           "tokens_request0": res.tokens[0].tolist(),
           "launches": {op: n for op, n in launches.items() if n},
           "profile": profiles}
    log(f"  {arch}: prefill {row['prefill_ms']:.3f} ms, decode "
        f"{row['decode_tok_per_s']:.2f} tok/s "
        f"({row['decode_ms_per_step']:.3f} ms a step), peak "
        f"{row['peak_gib']:.3f} GiB (torch.cuda.max_memory_allocated)")
    for step, v in errs.items():
        log(f"  {arch}: {step} logits, relative L2: "
            + ", ".join(f"{k} {x:.4g}" for k, x in v.items()))
    log(f"  {arch}: bf16 kernel vs plain route within {LM_ROUTE_RTOL}: "
        f"{row['bf16_routes_within_bound']}; same first token: "
        f"{same_first}")
    log(f"  {arch}: greedy tokens equal on the bf16 kernel and plain "
        f"routes, per request up to the first difference: {agree} of {G}")
    for step, pr in profiles.items():
        log(f"  {arch} profiled {step}: {pr['wall_ms_per_wave_profiled']:.3f}"
            f" ms wall, {pr['device_busy_ms_per_wave']:.3f} ms device-busy, "
            f"idle share {pr['device_idle_share']:.4f}, "
            f"{pr['device_events_per_wave']:.1f} device events; top: "
            + "; ".join(f"{t['name'][:48]} {t['ms_per_wave']:.3f} ms "
                        f"x{t['per_wave']:.0f}" for t in pr["top_device"][:5]))
    log(f"  {arch}: greedy tokens of request 0: {row['tokens_request0']}")
    log(f"  {arch}: launches {row['launches']}")
    for step, v in errs.items():
        if not v["f32 kernel vs plain"] <= LM_ROUTE_RTOL:
            raise AssertionError(f"{arch} {step}: float32 kernel and plain "
                                 f"routes differ by relative L2 "
                                 f"{v['f32 kernel vs plain']}")
        if not (v["bf16 kernel vs f32 plain"]
                <= 2 * v["bf16 plain vs f32 plain"] + LM_ROUTE_RTOL):
            raise AssertionError(f"{arch} {step}: the bf16 kernel route is "
                                 f"more than twice as far from the float32 "
                                 f"model as the plain route: {v}")
    del params, res, logits, prompt
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return row, launches


#: Training at published widths (ROADMAP A.12.3, A.12.3b): bf16
#: parameters, float32 master copy and moments, n_micro 4, remat; 4
#: sequences of 4,096 tokens a step (train_4k's length).  Each family's
#: depth is cut to the deepest multiple of its layer pattern, up to
#: TRAIN_LAYERS' cap, whose reckoned peak (train_reckoning) fits
#: TRAIN_FIT_GIB: qwen2-7b (d 3,584; 28 heads padded to 32 of 128 over 4
#: kv heads; d_ff 18,944; vocab 152,064; QKV bias) at 8 layers (28 need
#: ~143 GB of state); recurrentgemma-9b (d 4,096; RG-LRU
#: width 4,096; local attention 16/1 at D 256, window 2,048; vocab
#: 256,000) at 6; rwkv6-3b (d 2,560; 40 heads of 64; vocab 65,536) at 32.
TRAIN_ARCHS = ("qwen2-7b", "recurrentgemma-9b", "rwkv6-3b")
TRAIN_LAYERS = {"qwen2-7b": 8}
TRAIN_TRAFFIC = dict(batch=4, seq=4096, steps=2)
#: Reckoned peak device memory a training cut may have, of the card's
#: 79.6 GiB.
TRAIN_FIT_GIB = 72.0
#: Layers of the one-microbatch gradient gate.  The plain route's
#: per-token Python loops (rglru_plain, rwkv6_plain under autograd) take
#: seconds a recurrent layer at 4,096 tokens, so the hybrid gate runs one
#: (rec, rec, attn) block and rwkv6-3b's four layers.
TRAIN_GRAD_LAYERS = {"qwen2-7b": 8, "recurrentgemma-9b": 3, "rwkv6-3b": 4}
#: Relative L2 allowed between the kernel route's and the plain route's
#: float32 gradients of one microbatch (float32 sums in another order
#: through the layers), and the loss's relative difference.
TRAIN_GRAD_RTOL = 1e-3
TRAIN_LOSS_RTOL = 1e-5
#: A float32 gradient past TRAIN_GRAD_RTOL is held to the plain route run
#: in float64: the kernel route may be at most this many times as far
#: from it as the float32 plain route.  Past 2 layers rwkv6-3b's gradient
#: of u (the bonus) is a sum over 4,096 tokens that the per-head norm
#: after the wkv cancels nearly to zero, so float32 sums in any other
#: order than the plain route's move it by ~1e-3.
TRAIN_GRAD_F64_RATIO = 2.0


def _grad_errors(a: dict, b: dict) -> dict:
    """{parameter path: relative L2 of a's gradient against b's}."""
    from repro_torch.models.common import flatten
    fb = dict(flatten(b))
    return {"/".join(map(str, p)): rel_l2(g, fb[p]) for p, g in flatten(a)}


def _f64_gate(arch, gcfg, params, batch, grads, over, errs) -> dict:
    """Hold the float32 gradients ``over`` (past TRAIN_GRAD_RTOL, kernel
    against plain route) to the plain route on the float64 model: the
    kernel route at most TRAIN_GRAD_F64_RATIO times as far from it as
    the float32 plain route.  Returns {gradient: (kernel vs plain,
    kernel vs float64, float32 plain vs float64)}."""
    from repro_torch.models import steps
    from repro_torch.models.common import tree_map
    t0 = time.perf_counter()
    c64 = dataclasses.replace(gcfg, n_micro=1, param_dtype="float64")
    loss, g64 = steps.value_and_grad(
        tree_map(lambda t: t.detach().double(), params), c64, batch,
        plain=True)
    ek = _grad_errors(grads[("f32", "kernel")], g64)
    ep = _grad_errors(grads[("f32", "plain")], g64)
    del g64
    out = {k: (errs[k], ek[k], ep[k]) for k in over}
    log(f"  {arch} float32 gradients past {TRAIN_GRAD_RTOL} against the "
        f"float64 plain route (loss {float(loss):.9f}, "
        f"{time.perf_counter() - t0:.1f} s), relative L2 kernel "
        f"vs plain / kernel vs float64 / float32 plain vs float64: "
        + "; ".join(f"{k} {a:.3g} / {b:.3g} / {c:.3g}"
                    for k, (a, b, c) in out.items()))
    bad = {k: v for k, v in out.items()
           if not v[1] <= TRAIN_GRAD_F64_RATIO * v[2]}
    if bad:
        raise AssertionError(f"{arch} f32 gradients more than "
                             f"{TRAIN_GRAD_F64_RATIO} times as far from the "
                             f"float64 plain route as the float32 plain "
                             f"route's: {bad}")
    return out


def train_reckoning(cfg, seq: int) -> float:
    """Reckoned peak GiB of a training step of ``cfg``: 20 bytes a bf16
    parameter (the weight and its microbatch gradient, the float32
    accumulator, master copy, m and v; 16 for a float32 one), 24 bytes a
    logit of one microbatch (bf16 logits, their float32 copy, the
    softmax's exp, the gradients), and 3 GB for the layers' saved inputs
    and one layer's recomputed activations.  qwen2-7b x 8 reckons 62.1
    GiB and peaks at 62.3 (PERF.md)."""
    from repro_torch.models.common import flatten
    from repro_torch.models.model import model_schema
    n_bytes = 0
    for _, spec in flatten(model_schema(cfg)):
        numel = math.prod(spec.shape)
        n_bytes += numel * (20 if spec.dtype == "bfloat16" else 16)
    return (n_bytes + 24 * seq * cfg.vocab + 3e9) / 2 ** 30


def train_depth(arch: str, seq: int) -> tuple[int, float]:
    """(layers, reckoned GiB) of ``arch``'s training cut: the deepest
    multiple of its layer pattern, up to TRAIN_LAYERS' cap and its
    published depth, that fits TRAIN_FIT_GIB."""
    from repro_torch import configs
    full = configs.get(arch)
    step = len(full.pattern)
    best = None
    for n in range(step, min(full.n_layers,
                             TRAIN_LAYERS.get(arch, full.n_layers)) + 1,
                   step):
        gib = train_reckoning(dataclasses.replace(full, n_layers=n), seq)
        if gib <= TRAIN_FIT_GIB:
            best = (n, gib)
    if best is None:
        raise AssertionError(f"{arch}: no cut fits {TRAIN_FIT_GIB} GiB")
    return best


#: The training kernels of each layer type: its forward op and its
#: backward op.
LAYER_KERNELS = {"attn": ("flash_attention", "flash_attention_backward"),
                 "rec": ("rglru", "rglru_backward"),
                 "rwkv": ("rwkv6", "rwkv6_backward")}


def _train_launches(cfg, n_micro, steps=1) -> dict:
    """The kernel launches of ``steps`` training steps on the card: per
    layer and microbatch its kernel (LAYER_KERNELS) twice (the forward
    and remat's recompute) and its backward once; nothing else."""
    from repro_torch import kernels as K
    want = {op: 0 for op in K.WRAPPERS}
    for lt in cfg.layer_types():
        fwd, bwd = LAYER_KERNELS[lt]
        want[fwd] += steps * n_micro * (2 if cfg.remat else 1)
        want[bwd] += steps * n_micro
    return want


#: The training backwards' launches in a profile, by a piece of their
#: kernels' names (BWD_LAUNCHES: flash_attention_backward's).
TRAIN_BWD_LAUNCHES = BWD_LAUNCHES + (
    ("rglru bwd", "rglru_bwd_kernel"), ("rwkv6 bwd", "rwkv6_bwd_kernel"),
    ("rwkv6 bwd chains", "rwkv6_bwd_chain_kernel"),
    ("rwkv6 bwd chunk pass", "rwkv6_bwd_chunk_kernel"),
    ("rwkv6 bwd combine", "rwkv6_bwd_combine_kernel"),
    ("rwkv6 du sum", "du_sum_kernel"))


def lm_train_path(dev, arch="qwen2-7b", n_layers=None, seed=0,
                  smoke=False, **traffic):
    """The training path of ``arch`` at full width (``smoke``: the smoke
    config, a rehearsal on the CPU, where nothing launches), cut to
    ``n_layers`` (None: train_depth's cut).

    1. Gradients of one microbatch (one sequence) at TRAIN_GRAD_LAYERS
       on the float32 model (the bf16 weights cast up) through the
       kernel route and the plain route (``plain=True``: autograd
       through the plain versions): the loss within TRAIN_LOSS_RTOL,
       every parameter's gradient within relative L2 TRAIN_GRAD_RTOL;
       the kernel route launching each layer's kernel and its backward,
       the plain route nothing.  A gradient past TRAIN_GRAD_RTOL is held
       to the plain route on the float64 model instead: the kernel
       route's distance to it at most TRAIN_GRAD_F64_RATIO times the
       float32 plain route's.  Then
       the bf16 model's two routes: every bf16 kernel-route gradient at
       most twice as far from the float32 plain gradient as the bf16
       plain route's (+ LM_ROUTE_RTOL), lm_serve_path's rule.
    2. ``steps`` steps through ``launch.train.run_supervised`` with a
       CheckpointManager in a temp dir (its interval past the run and
       no final save: a checkpoint of this state, bf16 weights with
       float32 master, m and v, is tens of GB on disk), launch counters
       set to 0 just before and read just after: _train_launches
       exactly.  Step ms, tokens/s and peak GiB; one more step under
       torch.profiler: device-busy ms, idle share, top kernels, the
       backwards' launches (TRAIN_BWD_LAUNCHES) and their share.
    3. Three steps on one repeated batch lower the loss.
    4. The restart check on the smoke config through the kernels:
       run_supervised with one injected failure reaches its step, and
       the last checkpoint restores the final parameters and optimizer
       state bit for bit (continuation itself is exact only on the CPU:
       the embedding's backward sums with float atomics on the card).
    Returns (summary row, launches of step 2's run)."""
    import gc
    import tempfile
    from repro_torch import configs
    from repro_torch import kernels as K
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import make_batch
    from repro_torch.ft import FailureInjector
    from repro_torch.launch.train import TrainRun, run_supervised
    from repro_torch.launch.wave_profile import profile_device
    from repro_torch.models import model as model_mod
    from repro_torch.models import steps
    from repro_torch.models.common import flatten, tree_map
    from repro_torch.optim import AdamW
    traffic = {**TRAIN_TRAFFIC, **traffic}
    B, S, n_steps = traffic["batch"], traffic["seq"], traffic["steps"]
    full = configs.get(arch)
    base = configs.get_smoke(arch) if smoke else full
    reckoned = None
    if n_layers is None:
        n_layers, reckoned = train_depth(arch, S)
    cfg = dataclasses.replace(base, n_layers=min(n_layers, base.n_layers),
                              n_micro=full.n_micro, remat=True)
    gcfg = dataclasses.replace(cfg, n_layers=min(
        TRAIN_GRAD_LAYERS.get(arch, cfg.n_layers), cfg.n_layers))
    on_card = dev.type == "cuda"
    row = {"arch": arch, "layers": cfg.n_layers,
           "published_layers": full.n_layers, "reckoned_gib": reckoned,
           "grad_layers": gcfg.n_layers, "batch": B, "seq": S,
           "n_micro": cfg.n_micro}
    log(f"  {arch}: {cfg.n_layers} of {full.n_layers} layers "
        f"({'x'.join(cfg.layer_types()[:len(cfg.pattern)])} pattern), "
        f"reckoned peak {reckoned if reckoned is None else round(reckoned, 3)}"
        f" GiB of the {TRAIN_FIT_GIB} allowed (train_reckoning); gradient "
        f"gate at {gcfg.n_layers} layers")

    t_phase = time.perf_counter()

    def lap(what):   # seconds since the last lap, into row["seconds"]
        nonlocal t_phase
        now = time.perf_counter()
        row.setdefault("seconds", {})[what] = now - t_phase
        t_phase = now

    # 1. Gradients of one microbatch, kernel route against plain route.
    params = model_mod.init_params(gcfg, seed, dev)
    row["grad_params"] = sum(t.numel() for _, t in flatten(params))
    log(f"  {arch} x {gcfg.n_layers} layers (gradient gate): "
        f"{row['grad_params'] / 1e9:.3f} B parameters ({gcfg.param_dtype})"
        f", one sequence of {S} tokens")
    one = make_batch(gcfg, ShapeSpec("mb", "train", S, 1), 0, device=dev)
    grads, losses = {}, {}
    for dt in ("f32", "bf16"):
        c = dataclasses.replace(gcfg, n_micro=1, **(
            {"param_dtype": "float32"} if dt == "f32" else {}))
        p = tree_map(lambda t: t.detach().float(), params) \
            if dt == "f32" else params
        for route in ("kernel", "plain"):
            K.reset_launches()
            loss, g = steps.value_and_grad(p, c, one,
                                           plain=route == "plain")
            _sync(dev)
            got = K.launch_counts()
            want = (_train_launches(c, 1) if on_card and route ==
                    "kernel" else {op: 0 for op in K.WRAPPERS})
            if got != want:
                raise AssertionError(f"{arch} {dt} {route} route "
                                     f"launches {got}, want {want}")
            losses[(dt, route)] = float(loss)
            grads[(dt, route)] = g
        if dt == "f32":
            lk, lp = losses[("f32", "kernel")], losses[("f32", "plain")]
            if not abs(lk - lp) <= TRAIN_LOSS_RTOL * abs(lp):
                raise AssertionError(f"{arch} f32 loss: kernel {lk} vs "
                                     f"plain {lp}")
            errs = _grad_errors(grads[("f32", "kernel")],
                                grads[("f32", "plain")])
            worst = max(errs, key=errs.get)
            row["f32_loss"] = (lk, lp)
            row["f32_grad_rel_l2_max"] = (worst, errs[worst])
            log(f"  {arch} float32 model: loss kernel {lk:.7f} plain "
                f"{lp:.7f}; gradients' relative L2, kernel vs plain route: "
                f"max {errs[worst]:.3g} ({worst}), median "
                f"{statistics.median(errs.values()):.3g}")
            over = [k for k, e in errs.items() if e > TRAIN_GRAD_RTOL]
            if over:
                row["f32_grad_f64"] = _f64_gate(arch, gcfg, params, one,
                                                grads, over, errs)
            del grads[("f32", "kernel")], p
            gc.collect()
    ek = _grad_errors(grads[("bf16", "kernel")], grads[("f32", "plain")])
    ep = _grad_errors(grads[("bf16", "plain")], grads[("f32", "plain")])
    bad = {k: (ek[k], ep[k]) for k in ek
           if not ek[k] <= 2 * ep[k] + LM_ROUTE_RTOL}
    worst = max(ek, key=lambda k: ek[k] - 2 * ep[k])
    row["bf16_loss"] = (losses[("bf16", "kernel")],
                        losses[("bf16", "plain")])
    row["bf16_grad_worst"] = (worst, ek[worst], ep[worst])
    log(f"  {arch} bf16 model: loss kernel {row['bf16_loss'][0]:.5f} plain "
        f"{row['bf16_loss'][1]:.5f}; gradients' relative L2 to the float32 "
        f"plain route, kernel route vs plain route: worst {worst} "
        f"{ek[worst]:.4g} vs {ep[worst]:.4g}; median "
        f"{statistics.median(ek.values()):.4g} vs "
        f"{statistics.median(ep.values()):.4g}")
    if bad:
        raise AssertionError(f"{arch} bf16 kernel-route gradients more "
                             f"than twice as far from float32 as the "
                             f"plain route's: {bad}")
    del grads, losses, params, one
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    lap("gradient gate")

    # 2. Steps through the supervisor.
    shape = ShapeSpec("train", "train", S, B)
    opt = AdamW.from_config(cfg, peak_lr=1e-5, total_steps=100,
                            warmup_steps=0)
    with tempfile.TemporaryDirectory() as tmp:
        run = TrainRun(cfg=cfg, optimizer=opt, shape=shape,
                       ckpt=CheckpointManager(tmp, interval=10 ** 9,
                                              fingerprint=cfg.name),
                       log_every=1, device=dev)
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        _sync(dev)
        K.reset_launches()
        t0 = time.perf_counter()
        params, state, run_losses, restarts = run_supervised(
            run, n_steps, seed=seed, save_final=False)
        _sync(dev)
        wall = time.perf_counter() - t0
        launches = K.launch_counts()
        calls = K.call_counts()
        if os.listdir(tmp):
            raise AssertionError(f"{arch}: the run wrote a checkpoint")
    row["params"] = sum(t.numel() for _, t in flatten(params))
    log(f"  {arch} x {cfg.n_layers} layers: {row['params'] / 1e9:.3f} B "
        f"parameters ({cfg.param_dtype}), {B} x {S} tokens a step, "
        f"n_micro {cfg.n_micro}")
    want = (_train_launches(cfg, cfg.n_micro, n_steps) if on_card
            else {op: 0 for op in K.WRAPPERS})
    if launches != want:
        raise AssertionError(f"{arch}: {n_steps} steps launched "
                             f"{launches}, want {want}")
    if on_card and calls != launches:
        raise AssertionError(f"{arch}: wrapper calls {calls} != launches "
                             f"{launches}: something ran the plain route")
    if restarts or len(run_losses) != n_steps or not all(
            math.isfinite(x) for _, x in run_losses):
        raise AssertionError(f"{arch}: run {run_losses}, {restarts} "
                             f"restarts")
    # One more step of the same run, timed alone, then profiled.
    step_fn = steps.build_train_step(cfg, opt)
    batch = make_batch(cfg, shape, n_steps, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    params, state, m = step_fn(params, state, batch, n_steps)
    _sync(dev)
    step_s = time.perf_counter() - t0
    row.update({"run_s": wall, "run_losses": run_losses,
                "step_ms": step_s * 1e3, "tokens_per_s": B * S / step_s,
                "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                             if on_card else 0.0),
                "launches": {op: n for op, n in launches.items() if n}})
    lap("steps")
    if on_card:
        row["profile"] = profile_device(
            lambda: step_fn(params, state, batch, n_steps + 1), 1, top=40)
        row["backward_kernels"] = bwd_kernels(row["profile"]["top_device"],
                                              TRAIN_BWD_LAUNCHES)
        del row["profile"]["top_device"][8:]
    log(f"  {arch}: {n_steps} steps through run_supervised in "
        f"{wall:.3f} s, losses {run_losses}; launches {row['launches']}")
    log(f"  {arch}: one step {row['step_ms']:.3f} ms, "
        f"{row['tokens_per_s']:.1f} tokens/s, peak "
        f"{row['peak_gib']:.3f} GiB (torch.cuda.max_memory_allocated)")
    pr = row.get("profile")
    if pr:
        log(f"  {arch} profiled step: {pr['wall_ms_per_wave_profiled']:.3f}"
            f" ms wall, {pr['device_busy_ms_per_wave']:.3f} ms device-busy,"
            f" idle share {pr['device_idle_share']:.4f}, "
            f"{pr['device_events_per_wave']:.0f} device events; top: "
            + "; ".join(f"{t['name'][:48]} {t['ms_per_wave']:.3f} ms "
                        f"x{t['per_wave']:.0f}" for t in pr["top_device"]))
        bk = row["backward_kernels"]
        busy = pr["device_busy_ms_per_wave"]
        log(f"  {arch} profiled step: the backwards' launches "
            f"{sum(ms for ms, _ in bk.values()):.3f} ms of the busy "
            f"{busy:.3f} ("
            + ", ".join(f"{k} {ms:.3f} ms x{c:.0f}, {ms / busy:.1%}"
                        for k, (ms, c) in bk.items()) + ")")

    lap("profiled step")

    # 3. Three steps on one repeated batch lower the loss.
    seen = []
    for i in range(4):
        params, state, m = step_fn(params, state, batch, n_steps + 2 + i)
        seen.append(float(m["loss"]))
    row["repeated_batch_losses"] = seen
    log(f"  {arch}: losses on one repeated batch {seen}")
    if not seen[3] < seen[0]:
        raise AssertionError(f"{arch}: three steps on one batch did not "
                             f"lower the loss: {seen}")
    del params, state, batch, step_fn, m
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    lap("repeated batch")

    # 4. Restart: the smoke config through the kernels, one failure.
    sc = configs.get_smoke(arch)
    with tempfile.TemporaryDirectory() as tmp:
        ck = CheckpointManager(tmp, interval=2, fingerprint=sc.name)
        run = TrainRun(cfg=sc, optimizer=AdamW.from_config(
            sc, total_steps=6, warmup_steps=1),
            shape=ShapeSpec("t", "train", 64, 4), ckpt=ck,
            injector=FailureInjector(at_steps=(3,)), log_every=100,
            device=dev)
        K.reset_launches()
        p6, o6, _, restarts = run_supervised(run, 6, seed=seed)
        got = K.launch_counts()
        restored, manifest = ck.restore_latest(
            {"params": p6, "opt": o6})
        same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            flatten(restored), flatten({"params": p6, "opt": o6})))
    ops = sorted({op for lt in sc.layer_types() for op in LAYER_KERNELS[lt]})
    row["restart"] = {"restarts": restarts, "step": manifest["step"],
                      "restore_bit_exact": same,
                      "launches": {op: got[op] for op in ops}}
    log(f"  {sc.name} smoke restart: {restarts} restart, checkpoint at step "
        f"{manifest['step']}, restore bit for bit {same}; launches "
        f"{row['restart']['launches']}")
    if not (restarts == 1 and manifest["step"] == 6 and same):
        raise AssertionError(f"restart check: {row['restart']}")
    if on_card and not min(row["restart"]["launches"].values()) > 0:
        raise AssertionError(f"restart check ran no kernel: "
                             f"{row['restart']['launches']}")
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    lap("restart")
    log(f"  {arch}: seconds " + ", ".join(f"{k} {v:.1f}" for k, v in
                                         row["seconds"].items()))
    return row, launches


def ratios(workload, by):
    """Log the paper's orderings: OCC-fine over OCC-coarse and
    TicToc-coarse (quickstart), 2PL over TicToc coarse at T=128 (Fig 3a),
    and AutoGran's share of the coarse-to-fine OCC gain
    (benchmarks/auto_granularity.py)."""
    th = {k: r["throughput"] for k, r in by.items()}
    share = ((th["autogran-coarse"] - th["occ-coarse"])
             / max(th["occ-fine"] - th["occ-coarse"], 1e-9))
    log(f"  {workload}: OCC-fine / OCC-coarse "
        f"{th['occ-fine'] / th['occ-coarse']:.4f}  OCC-fine / TicToc-coarse "
        f"{th['occ-fine'] / th['tictoc-coarse']:.4f}  2PL / TicToc coarse "
        f"{th['2pl-coarse'] / th['tictoc-coarse']:.4f}  AutoGran-coarse / "
        f"OCC-coarse {th['autogran-coarse'] / th['occ-coarse']:.4f}, "
        f"recovering {share:.4f} of the OCC fine gain")


def ptxas_report(text: str) -> list:
    """[(kernel, registers, (spill store bytes, spill load bytes))] from
    nvcc's -Xptxas -v log; the kernel is its mangled name without the
    anonymous namespace's prefix, cut to 48 characters."""
    import re
    out, fn, spill = [], "?", None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "",
                        m.group(1))[:48]
            spill = None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append((fn, int(m.group(1)), spill))
    return out


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="a parent commit unpacked in DIR: time its build "
                         "of PARENT_KERNELS (rwkv6's backward) beside this "
                         "checkout's on the same inputs, in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import kernels as K
    from repro_torch.kernels import build
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    def phase(title):
        log(f"[{time.perf_counter() - t_start:.1f} s] {title}")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    logs = build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(logs)}")
    for name, text in sorted(logs.items()):
        for fn, regs, spill in ptxas_report(text):
            log(f"  {name}: {fn}: {regs} registers, {spill} bytes spilled "
                f"(stores, loads)")

    parent = parent_kernels(args.parent) if args.parent else None
    phase("kernels vs plain versions:")
    checks, timings = kernel_phase(dev, SHAPES)

    phase("main path, TPC-C:")
    tpcc, l_tpcc = main_path("tpcc", dev, **MAIN_KW["tpcc"])
    ratios("tpcc", tpcc)
    occ_f = tpcc["occ-fine"]["throughput"]
    if not (occ_f > tpcc["occ-coarse"]["throughput"]
            and occ_f > tpcc["tictoc-coarse"]["throughput"]):
        raise AssertionError("quickstart ordering fails: OCC-fine must beat "
                             "OCC-coarse and TicToc-coarse on TPC-C")
    # The JAX reference orders them so at TPC-C scale 0.1, T=128 (its CLI,
    # jnp backend, on the CPU).
    if not tpcc["autogran-coarse"]["throughput"] > tpcc["occ-coarse"][
            "throughput"]:
        raise AssertionError("AutoGran-coarse must beat OCC-coarse on TPC-C")

    phase("main path, YCSB:")
    ycsb, l_ycsb = main_path("ycsb", dev, **MAIN_KW["ycsb"])
    ratios("ycsb", ycsb)

    phase("unfused route, TPC-C:")
    _, l_unf = unfused_path(dev, tpcc, scale=1.0)

    phase("scan path, TPC-C:")
    tpcc_s, l_tpcc_s = scan_path("tpcc", dev, **SCAN_KW["tpcc"])
    phase("scan path, YCSB:")
    ycsb_s, l_ycsb_s = scan_path("ycsb", dev, **SCAN_KW["ycsb"])

    phase("multi-version path:")
    mv, mv_phases = mv_path(dev)

    phase("fused = unfused on the card:")
    fused_unfused(dev)
    fused_unfused(dev, scan_len=SCAN_KW["tpcc"]["scan_len"])

    phase("cross-device identity:")
    cross_device(dev)
    cross_device(dev, waves=20, scan_len=SCAN_KW["tpcc"]["scan_len"],
                 configs=SCAN_CONFIGS)

    phase("backend op probe on the card:")
    l_probe = backend_probe_path(dev)
    phase("quickstart (examples/quickstart_torch.py):")
    _, l_quick = quickstart_path(dev)
    phase("figures: fig3's grid through the port's sweep:")
    fig_rows, l_fig, fig_ratios = figures_path(dev, scale=1.0)
    log("fig3_ratios " + json.dumps(fig_ratios))
    phase("cross-device identity with padding:")
    cross_device_padded(dev)
    phase("open loop, YCSB:")
    open_rows, l_open = open_loop_path(dev)
    phase("cross-device identity, open loop:")
    cross_device_open(dev)
    phase("sync-free waves (set_sync_debug_mode('error') and the profiler):")
    l_sync, n_sync = sync_free_path(dev)
    phase("observability: the conflict histogram and the per-wave timeline:")
    l_obs, n_obs = observability_path(dev)
    phase("cross-device identity, tracked:")
    cross_device_observability(dev)
    phase("tracked values: the serial replay into the values and the ring:")
    l_val, n_val = values_path(dev)
    phase("cross-device identity, tracked values:")
    cross_device_values(dev)

    phase("sharded engine, one-rank NCCL group:")
    import torch.distributed as dist
    from repro_torch.launch import txn_scaling
    from repro_torch.launch.mesh import close_shards, init_shards
    shards = init_shards(dev, mesh_shape=(1, 1))
    try:
        kept = {}
        dist_rows, l_dist, n_dist = sharded_path(dev, keep=kept)
        phase("sharded engine, card = CPU (gloo group for the CPU run):")
        cpu_group = dist.new_group(backend="gloo")
        sharded_cross_device(dev, cpu_group=cpu_group)
        phase("sharded open loop, one-rank NCCL group:")
        l_dopen, n_dopen = sharded_open_path(dev)
        phase("sharded open loop, card = CPU:")
        sharded_open_cross_device(dev, cpu_group=cpu_group)
        phase("sharded pipeline, one rank (depth forced to 2):")
        l_pipe, n_pipe = sharded_pipeline_path(dev, kept, dist_rows)
        del kept
        phase("sharded open pipeline, one rank (depth forced to 2):")
        l_opipe, n_opipe = sharded_open_pipeline_path(dev)
        phase("sharded pipeline, card = CPU:")
        sharded_pipeline_cross_device(dev, cpu_group=cpu_group)
        phase("axis-wise exchange, one rank:")
        axiswise_path(dev, shards)
        phase("sharded scaling rows (repro_torch.launch.txn_scaling):")
        K.reset_launches()
        scaling = txn_scaling.scaling_rows(shards, waves=30)
        l_scale = K.launch_counts()
        for r in scaling:
            log("  " + json.dumps(r))
    finally:
        close_shards(shards)

    phase("LM serving:")
    torch.cuda.empty_cache()
    lm_checks, lm_timings = lm_kernel_phase(dev)
    phase("flash_attention's backward and lse vs plain versions:")
    bwd_check, bwd_timing = flash_backward_phase(dev)
    phase("rglru's and rwkv6's backwards vs plain versions:")
    rec_checks, rec_timings = recurrent_backward_phase(dev, parent=parent)
    lm_rows, lm_launches = [], {op: 0 for op in K.WRAPPERS}
    for arch in LM_ARCHS:
        phase(f"LM serving, {arch}:")
        row, launched = lm_serve_path(dev, arch)
        lm_rows.append(row)
        for op, n in launched.items():
            lm_launches[op] += n
    log("lm_serving " + json.dumps(lm_rows))
    train_rows = []
    for arch in TRAIN_ARCHS:
        phase(f"LM training, {arch}:")
        row, launched = lm_train_path(dev, arch)
        train_rows.append(row)
        for op, n in launched.items():
            lm_launches[op] += n
        torch.cuda.empty_cache()
    log("lm_training " + json.dumps(train_rows))

    runs = {"tpcc": (l_tpcc, len(tpcc) * WAVES),
            "ycsb": (l_ycsb, len(ycsb) * WAVES),
            "tpcc_unfused": (l_unf, len(UNFUSED) * WAVES),
            "tpcc_scans": (l_tpcc_s, len(tpcc_s) * WAVES),
            "ycsb_scans": (l_ycsb_s, len(ycsb_s) * WAVES),
            **mv_phases,
            "backend_probe": (l_probe, 1),
            "quickstart": (l_quick, 3 * WAVES),
            "fig3": (l_fig, len(fig_rows) * WAVES),
            "open_loop": (l_open, len(open_rows) * WAVES),
            "sync_free": (l_sync, n_sync),
            "observability": (l_obs, n_obs),
            "values": (l_val, n_val),
            "sharded": (l_dist, n_dist * WAVES),
            "sharded_open": (l_dopen, n_dopen),
            "sharded_pipeline": (l_pipe, n_pipe),
            "sharded_open_pipeline": (l_opipe, n_opipe),
            "scaling": (l_scale, (30 + txn_scaling.WARMUP_WAVES)
                        * len(scaling))}
    per_wave = {op: {k: n[op] / w for k, (n, w) in runs.items()}
                for op in KERNEL_META}
    log("launches per wave (mean over each phase's configurations): "
        + json.dumps(per_wave))
    log("kernel_times " + json.dumps(
        {label: {n: {k: (v if k != "bound" else list(v)) for k, v in r.items()}
                 for n, r in t.items()} for label, t in timings.items()}))
    kernels = []
    for name, (src, replaces) in KERNEL_META.items():
        t = timings["dist" if name in DIST_KERNELS else "tpcc"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(n[name] for n, _ in runs.values()),
            "max_abs_err": checks[name].max_err,
            "equal": checks[name].equal,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"],
            "shape": t.get("shape", "tpcc T=128 K=64 N=2450808 G=2"),
            "form": t.get("form"),
            "parent_ms": t.get("parent_ms"), "split_ms": t.get("split_ms"),
            "noring_ms": t.get("noring_ms"),
            "forms": {f: {**{k: v for k, v in r.items()
                             if k == "ms" or k.endswith("_ms")
                             or k in ("shape", "form")},
                          "bound_ms": r["bound"][0]}
                      for label, table in (("tpcc", KERNEL_FORMS),
                                           ("dist", DIST_FORMS))
                      for f in table.get(name, ())
                      for r in (timings[label][f],)},
        })
    for name, (src, replaces) in LM_KERNEL_META.items():
        t = lm_timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": lm_launches[name],
            "max_abs_err": lm_checks[name].max_err,
            "max_bf16_ulps": lm_checks[name].max_ulps,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"], "shape": t["shape"],
            "parent_ms": t.get("parent_ms"),
            "qwen2_7b_prefill": t.get("qwen2_7b_prefill"),
        })
    kernels.append({
        "name": "flash_attention_backward", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:88",
        "launches": lm_launches["flash_attention_backward"],
        "max_abs_err": bwd_check["max_abs_err"],
        "max_rel_l2": bwd_check["dq_dk_dv_rel_l2"],
        "lse_max_abs_err": bwd_check["lse_max_abs_err"],
        "ms": bwd_timing["ms"], "plain_ms": bwd_timing["plain_ms"],
        "bound_ms": bwd_timing["bound"][0],
        "bound_by": bwd_timing["bound"][1],
        "library_ms": bwd_timing["library_ms"],
        "forward_lse_ms": bwd_timing["forward_lse_ms"],
        "forward_ms": bwd_timing["forward_ms"],
        "forward_bound_ms": bwd_timing["forward_bound_ms"],
        "library_causal_ms": bwd_timing["library_causal_ms"],
        "split_ms": bwd_timing["split_ms"],
        "split_launches": bwd_timing["split_launches"],
        "busy_ms": bwd_timing["busy_ms"],
        "shape": bwd_timing["shape"],
        "d256": {k: (list(v) if k == "bound" else v)
                 for k, v in bwd_timing.get("d256", {}).items()},
    })
    for name, (src, replaces) in RECURRENT_BWD_META.items():
        t, c = rec_timings[name], rec_checks[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": lm_launches[name],
            "max_abs_err": c["max_abs_err"], "max_rel_l2": c["max_rel_l2"],
            "bit_identical": {r: [g for g, v in b["bit_identical"].items()
                                  if v] for r, b in c["by_route"].items()},
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"], "shape": t["shape"],
            "parent_ms": t["parent_ms"], "split_ms": t["split_ms"],
            "split_launches": t["split_launches"], "busy_ms": t["busy_ms"],
            **{label: {k: (list(v) if k == "bound" else v)
                       for k, v in t[label].items()}
               for label in RWKV_BWD_TIMED if label in t},
        })
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
