"""Smoke run of the PyTorch/CUDA port (deeprank2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device and build: the card, torch and CUDA versions, and the nvcc build of
   every kernel source of the main paths, all sources at once (with ptxas's
   register report);
2. kernels against their plain PyTorch versions on the card:
   - diag_kernel and pool_bwd_kernel at the dense path's shapes (G=512
     graphs of N=160 nodes, F=32 and 64), at the full (F=32) and pooled
     (F=64) adjacencies of both clustered layouts ([512, 296, 296] and
     [512, 32, 32]; mixed [512, 336, 336] and [512, 104, 104]) and at a
     ragged shape (G=7, N=96, F=38, padded nodes masked), rtol=atol=1e-5 (both
     f32, only the summation order differs); K1 and K2 run the tensor-core
     body (mma.sync; K1's f32 form over three exact bf16 pieces of x, K2 a
     count product), and the bench adjacency is checked once more as f32
     (the FMA body on an f32 adjacency);
   - slot_fwd_kernel and slot_bwd_kernel at slots 8, 4 and 2, at the
     clustered path's activation width (F=32, V=151,552) and at a ragged one
     (F=38, V=8,024), and at the mixed layout's three size-class regions
     (slot 8, 4 and 2 on V = G * region width, each with the region's own
     slice of the node mask, as diag_depth0_pool gives them), on non-negative
     masked h with planted ties and an all-zero group, directly and through
     slot_group_max's autograd: exact (rtol=atol=0; a max and a comparison,
     no sums);
   then each kernel's time at the main paths' calls (the dense, the pure
   clustered and the mixed clustered layouts: K1 on the full and pooled
   adjacencies, K3/K4 on each slot region) beside its plain version, one
   library call of the same function where there is one, and its bound
   (K1/K2 rows also with their body, "mma" or "fma", their tensor-core
   passes and mma_floor_ms, the passes' dense products at the bf16
   tensor-core peak), and the FMA body (fma_body_calls: the f32 adjacency
   at the bench shape, and K1's int8 f32 form, which it ran before, at the
   dense and clustered paths' calls);
3. the dense path: GINetDense(38, 2, 6) on the bench batch
   (synthetic_entries(512, 160, 38, 6, seed=7)). First one dropout-free step
   is held against the same step on the CPU (logits, loss and every gradient
   at rtol=1e-4, atol=1e-6). Then, with the launch counters set to 0, STEPS
   train steps (CrossEntropy, backward, Adam lr 1e-3 wd 1e-5, dropout from a
   seeded generator) and one eval forward; the counters must read
   diag_kernel 3*STEPS + 2, pool_bwd_kernel STEPS and no slot kernel;
4. a profile of a few dense train steps: device time by kernel, idle share;
5. the clustered path: GINetClusteredDiag(38, 2, 1) on
   ppi_clustered_entries(512, 160, 38, seed=0), collated with the layout the
   data selects (pure slot8: [512, 296, 296]). One dropout-free step against
   the CPU (logits and loss at rtol=1e-4, atol=1e-5; gradients at
   rtol=1e-4, atol=1e-6, as the dense step: both sides are f32), the number of
   slot groups whose max-pool winner differs between card and CPU (each
   flip only inside its rounding band against float64: the two lanes'
   activations within c 2^-24 of their sums of |terms|), then
   CLUSTERED_STEPS train steps and one eval forward with the counters at 0:
   diag_kernel 4*S + 2, slot_fwd_kernel S + 1, slot_bwd_kernel S;
6. a profile of a few clustered train steps;
7. the clustered path in the mixed size-class layout
   (ppi_clustered_entries(..., cell=6.0)): the same checks over MIXED_STEPS
   steps; every forward runs the slot kernels at strides 8, 4 and 2, so the
   counters read diag_kernel 4*S + 2, slot_fwd_kernel 3*(S + 1),
   slot_bwd_kernel 3*S;
8. the BCSR kernel against its plain version on the card: bcsr_spmm_kernel
   at the 100k-node atomic graph's structure (3 column chunks, F=32 and 64),
   at the clustered collate's full (2 chunks, F=32) and pooled (F=64)
   structures, at a ragged batch (graphs of 700 and 1,300 nodes and an empty
   padding graph, F=38) and at an empty-edge graph, directly and through
   bcsr_spmm_t's autograd (the gradient is the same SpMM of the cotangent),
   rtol=atol=1e-5 (both f32, only the summation order differs), and at the
   atomic graph's structure with its int8 blocks reweighted in {-2, -1, 1, 3}
   (signed_structure; rtol 1e-5, atol DW_TOL x max |A||x|); then, in both
   forms, the kernel against bcsr_spmm_order_ref, the float32 loop in its
   summation order, bit for bit (max_abs_diff 0.0) at the atomic graph
   (F=32, 64) and the clustered full (F=32) and pooled (F=64) structures;
   the slot kernels exactly at the clustered BCSR path's width ([32,
   108,544], with its node-mask row); then each kernel's time at the two
   BCSR paths' calls beside its plain version, one cuSPARSE product of the
   same function (``torch.sparse_csr_tensor @ x``), one read of the nonzero
   blocks (blocks_read_ms) and its bound;
9. the BCSR path: GINetBlockSparse(38, 2, 6) on
   collate_graphs_blocksparse([geometric_entry(100_000, 38, 6)]). One
   dropout-free step against the CPU (logits and loss at rtol=1e-4,
   atol=1e-5; gradients at rtol=1e-4, atol=1e-6; the CPU runs the plain
   version at full size), then BCSR_STEPS train steps and one eval forward
   with the counters at 0: bcsr_spmm_kernel 4*S + 2 and no other kernel;
   then a profile of a few of its steps;
10. the clustered BCSR path: GINetClusteredBlockSparse(38, 2, 1) on
   collate_graphs_blocksparse_clustered([clustered_entry(100_000, 38, 1)],
   slot8=True): the same step against the CPU with the number of slot
   groups whose max-pool winner differs, then BCSR_STEPS steps and one eval
   forward: bcsr_spmm_kernel 4*S + 2, slot_fwd_kernel S + 1,
   slot_bwd_kernel S, diag_kernel 0; then a profile;
11. the blocked-edge kernels against their plain versions on the card:
   blocked_fwd_kernel (K6f) and blocked_bwd_kernel (K6b) at the 100k-node
   atomic graph's blocked structure (M=32 and M=12), at a ragged batch
   (graphs of 700 and 1,300 nodes, a 300-node graph without edges and an
   empty padding graph), at a structure with three capacity-pad slabs and at
   one without edges (exact zeros), directly and through
   blocked_message_sum's autograd Function: out, dxr and dxc at
   rtol=atol=1e-5 (both f32 on bit-identical pre-activations, only the
   summation order differs); dw_e, which sums one product per edge, at rtol
   1e-5 and an atol of DW_TOL times the sum of the products' absolute
   values; out, dxr and dxc against blocked_order_ref, the float32 loop in
   ascending slot order, bit for bit (max_abs_diff 0.0). Then each kernel's
   time at the blocked path's calls, with the L2 flushed and warm, beside
   its plain version and its bound (no single PyTorch call computes
   either), and the edge bytes read per edge through the edge slots (the
   earlier kernels' read) and from the destination-ordered stream;
12. the blocked-edge path: VanillaNetworkBlocked(38, 2, 6) on
   collate_graphs_blocked([geometric_entry(100_000, 38, 6)]): the same step
   against the CPU and sum-of-logits probe as the BCSR paths, then
   BCSR_STEPS train steps and one eval forward: blocked_fwd_kernel 2*S + 2,
   blocked_bwd_kernel 2*S and no other kernel; then a profile;
13. the sorted segment-sum kernel against its plain version on the card:
   segment_sum_sorted_kernel (K7) at the COO paths' calls (the coo batch's
   rows at F=16 and 32, the coo_clustered batch's full rows at F=16 and its
   pooled rows at F=32, VanillaNetwork's M=32 on relu'd messages), at the
   100k-node atomic graph's COO rows (F=32, E=4,221,824), at a ragged case
   (F=12, padding num_segments + 7, empty segments) and at E=0, directly and
   through segment_sum_sorted's autograd (its VJP is a gather),
   rtol=atol=1e-5 (both f32, only the summation order differs); segments
   without a message must be exact zeros. Then K7's time at each COO path's
   calls beside its plain version, one library call (index_add_ into an
   [n+1, F] buffer with the ids clamped to n) and its byte bound, and its
   two launches apart from the profiler (offsets_ms, sum_ms);
14. the COO paths, each checked one step against the CPU (with the
   sum-of-logits probe), driven SEGMENT_STEPS train steps and one eval
   forward with the counters at 0, and profiled: GINet no-cluster (38, 2, 6)
   on collate_graphs of the bench entries (coo; K7 4*S + 4), the clustered
   GINet(38, 2, 1) on collate_graphs of the clustered entries
   (coo_clustered; K7 4*S + 4), VanillaNetwork(38, 2, 6) on the coo batch
   (coo_vanilla; K7 2*S + 2), every other kernel 0;
15. the coo_clustered step with the segment ops' earlier boolean-mask form
   patched back in, against the step as it is, in turns: the host time the
   masks cost;
16. the fast paths against their COO oracle on one shared state_dict, eval
   mode, logits and the gradient of the sum of the logits, the oracle
   computed in float64 (its f32 run's own errors reported): GINetDense on the
   bench batch (on its flat route and on the batched tower backend; logits
   and the head's gradients at rtol 1e-4, atol 1e-5, the conv weights'
   gradients, sums over every node, against the tower function in float64
   at the per-entry gate of tools/f64_gate.py, atol max(1e-5, c 2^-24 x the
   entry's sum of |products|), with the flat route's relu flips held to
   their band) and GINetBlockSparse on the atomic BCSR batch against the
   no-cluster GINet, VanillaNetworkBlocked on the atomic blocked batch
   against VanillaNetwork (rtol 1e-4, atol 1e-5), and GINetClusteredDiag
   (pure slot8) against the clustered GINet at the 1e-3 gate of
   tests/perf/clustered_parity.py: logits and the head's gradients (1e-3 of
   their largest magnitude, at least 1e-3); the conv weights' gradients,
   which pass through the max pools, are reported with the COO pools under
   their own tie rule (shared among tied rows) and under the fast path's
   (full cotangent to each), since structural positive ties make the two
   rules differ;
17. the fused GINet tower kernels against their plain versions on the card:
   ginet_tower_fwd_kernel and ginet_tower_bwd_kernel (K8f/K8b, batched
   layout) and tower_fwd_kernel and tower_bwd_kernel (K9f/K9b, flat layout),
   with the fused weights of a seeded GINetDense(38, 2, 6), at the bench
   batch, at the ragged batches (G=9, N=33; G=7, N=96) and at the largest N
   each family's shape rule admits (ginet_tower.supports: 352 for K8,
   diag_spmm.tower_supports: 400 for K9), directly and through their autograd
   Functions: pooled and h1 at rtol=atol=1e-5; dw1, dw2, t1 and t2 (t1
   cancels terms far larger than itself) at rtol 1e-5 and an atol of DW_TOL
   times the sum of their products' absolute values, at least 1e-5; the sign
   exactly wherever |h2| > 1e-6 max|h2|; K9f's h1 and sign bit for bit
   against tower_fwd_order_ref (the kernel's order as a loop), K9b's f32 t2
   bit for bit against fl(g_pool x the count of neighbours whose sign is
   set), and tower_pooled's dw1, dw2 against float64 at the per-entry gate
   (against tower_pooled_ref reported). Then each kernel's
   time at the bench batch beside its plain version, the flat route's
   kernels for the same function (K1 relu F=32 and K1 pool F=64 forward, K2
   and K1 plain F=32 backward) and its bound (no single PyTorch call
   computes any of them), K8b's two launches apart (partials_ms, sum_ms);
18. the dense path on the batched tower backend
   (set_dense_tower_backend("pallas")): the dropout-free step against the
   CPU at STEP_TOL (the CPU runs the plain version at full size), STEPS train
   steps and one eval forward with the counters at 0
   (ginet_tower_fwd_kernel STEPS + 1, ginet_tower_bwd_kernel STEPS, every
   other kernel 0), and a profile;
19. the fused flat tower, tower_pooled, on the bench batch with the same
   weights: the fused tower, the flat route (diag_layer_t then
   diag_layer_pool_t) and tower_pooled_ref each against the function in
   float64 (tools/f64_gate.py: pooled at CROSS_TOL, dw1 and dw2 at the
   per-entry gate, each route's relu flips counted and held to their band;
   a gate row per route), the routes against each other reported, then
   STEPS forward/backward passes and one forward with the counters at 0
   (tower_fwd_kernel STEPS + 1, tower_bwd_kernel STEPS, every other kernel
   0);
20. the weighted kernel forms against their plain versions on the card
   (both f32 on the same exact weights, only the summation order differs;
   K1/K2 at rtol=atol=1e-5, K5 at rtol 1e-5 and an atol of DW_TOL times the
   largest sum of the products' absolute values, at least 1e-5, since a
   pooled pair's weight sums its member edges'): bcsr_spmm_kernel (K5) on
   the bf16 blocks of the weighted
   100k-node clustered graph (full structure F=16, pooled F=32), on the
   pooled blocks cast to f32, and on a ragged weighted batch (F=19);
   diag_kernel and pool_bwd_kernel (K1, K2) on the bf16 weighted adjacencies
   of the clustered PPI batch ([512, 296, 296] F=16, pooled F=32), on the
   pooled one cast to f32, on a small weighted batch (F=38) and on a
   synthetic weighted N=336 (every mode, directly and through the autograd
   Functions); the launch counters by adjacency and block type must show
   every one of these calls on the kernel;
21. their times at the new paths' calls beside the plain versions, one
   library call (cuSPARSE on the f32 weights; torch.bmm of the adjacency
   cast to f32) and the bounds (bf16 weights at 2 bytes an entry), with the
   FoutNet paths' unweighted calls (K1 and K5 at F=16 and 32) and the slot
   kernels at F=16; the f32 storage forms on no path's step;
22-25. the FoutNet and sGAT paths, CrossEntropy and Adam (lr 1e-3, wd 1e-5),
   no dropout: SGATDiag(38, 2, 1) on the weighted clustered PPI batch
   (sgat_diag: bf16 K1 4 a step), FoutNetDiag(38, 2, 1) on the unweighted one
   (foutnet_diag: int8 K1 4 a step), SGATBlockSparse(38, 2, 1) on the
   weighted clustered_entry(100_000, 38, 1) in slot8 (sgat_bcsr: bf16 K5 4
   a step) and FoutNetBlockSparse(38, 2, 1) on the unweighted one
   (foutnet_bcsr: int8 K5 4 a step), each with K3 and K4 once a step: one
   step against the CPU (on clustered_entry(20_000, 38, 1) for the two
   100k-node paths; gradients at rtol 1e-4, atol 1e-5), SGAT_FOUTNET_STEPS steps and one eval forward with the
   counters at 0, totals and types (4*S + 2, slot S + 1 and S), and a
   profile;
26. the four against their COO oracle (SGAT, FoutNet) in f64, with f32
   weight storage, logits and the head's gradients at the 1e-4 gate, the
   conv gradients reported under both max-pool tie rules;
27. the single-pass bf16 forms (compute_dtype=bfloat16) against their plain
   versions on the card, which round at the same points (both sum in f32,
   only the order differs; the tolerances of phases 2, 8, 11 and 20): K1
   and K2 on the int8 adjacencies of the dense and clustered Diag paths, on
   sGAT's bf16 one and at the largest N of each adjacency type
   (diag_max_nodes), every mode and both layer VJPs; K5 on the int8 blocks
   of both BCSR paths, on sGAT's bf16 blocks and on f32 ones (which the bf16
   form rounds); K6f and K6b at the atomic blocked graph, a ragged batch and
   no edges (out, dxr and dxc also bit for bit against the ordered float32
   loop, which rounds as the bf16 form does). The launch counters by form
   must show every call on its bf16 form;
28. their times at the bf16 paths' calls (bf16 operands, 2 bytes an entry
   in the bounds) beside the f32 form's on the same values, torch.bmm on
   bf16 operands (K1, K2) and cuSPARSE on bf16 values where it takes them
   (K5); the bf16-adjacency, bf16-block and f32-block forms on no path's
   step;
29-32. the bf16 train paths of the JAX bench (bench.py:129,179,229,324):
   GINetDense(38, 2, 6) on the bench batch (dense_bf16: K1 3*S + 2 and K2 S
   of the int8/bfloat16 form), GINetBlockSparse(38, 2, 6) on the atomic
   BCSR batch (bcsr_bf16: K5 4*S + 2), GINetClusteredBlockSparse(38, 2, 1)
   on the clustered one (clustered_bcsr_bf16: K5 4*S + 2, K3 S + 1, K4 S)
   and VanillaNetworkBlocked(38, 2, 6) on the atomic blocked batch
   (blocked_bf16: K6f 2*S + 2, K6b 2*S), with no launch of any f32 form:
   each one step against the CPU (which runs the same bf16 forms in their
   plain versions) at BF16_STEP_TOL, S = BCSR_STEPS steps and one eval
   forward with the counters at 0, and a profile; then GINetClusteredDiag's
   bf16 step against the CPU;
33. the bf16 forms of the fused towers (K8f, K8b, K9f, K9b) against their
   plain versions at the shapes of phase 17, directly and through
   ginet_tower_pooled and tower_pooled: f32 order (rtol 1e-5, atol DW_TOL
   times the sum of the terms' absolute values) on all but FLIP_SHARE of
   each output's entries, which may be off by one bf16 step of the chain
   (FLIP: a value rounded after sums in other orders can land on the
   neighbouring bf16 number), K9f's sign only within that band of zero, t2
   and t1 bf16; every call on the int8/bfloat16 form;
34. their times at the bench batch (f32 x, rounded as it is staged; K9b
   writes t2/t1 at 2 bytes; the weight products' bound at the bf16
   tensor-core rate), beside the f32 forms on the same values and the flat
   route's bf16 K1/K2;
35. dense_tower_bf16: GINetDense(38, 2, 6, compute_dtype=bfloat16) on the
   "pallas" tower at the bench batch: one step against the CPU at
   BF16_STEP_TOL, STEPS steps and one eval forward with the counters at 0
   (K8f STEPS + 1, K8b STEPS, all of the int8/bfloat16 form, every other
   kernel 0), and a profile;
36. dense_fused_tower_bf16: tower_pooled in bf16 on the bench batch, once
   against the CPU's pass and against tower_pooled_ref in bf16 (the plain
   ops, written apart) at BF16_STEP_TOL, then STEPS passes and one forward
   (K9f STEPS + 1, K9b STEPS, all int8/bfloat16);
37. the bf16 K1 and K5 calls of the four FoutNet/sGAT bf16 paths, timed
   beside their f32 forms;
38-41. sgat_diag_bf16, foutnet_diag_bf16, sgat_bcsr_bf16 and
   foutnet_bcsr_bf16: the models of phases 22-25 with
   compute_dtype=bfloat16 on the same batches, each one step against the CPU
   at BF16_STEP_TOL (the 100k-node ones on clustered_entry(20_000, 38, 1)),
   SGAT_FOUTNET_STEPS steps and one eval forward with the counters at 0
   (4*S + 2 of the bf16 K1 or K5 form: bfloat16/bfloat16 for sGAT,
   int8/bfloat16 for FoutNet; K3 S + 1, K4 S), and a profile; then SGATDiag
   in bf16 on the f32 adjacency of weight_dtype=float32 (JAX's XLA
   fallback: K1's bf16 form on the adjacency rounded to bf16, its output
   rounded) one step against the CPU;
42. trainer_dense: GINetDense(38, 2, 6) through ``Trainer.train`` on
   synthetic_entries(1024, 160, 38, 6, seed=7), held in memory by a
   GraphDataset subclass (this machine has no h5py), batches of 512 (the
   Trainer's dense collate pads N to 192). First a dropout-free Trainer on
   the card and one on the CPU from the same weights, one epoch of the first
   512 entries each: the epoch-0 logits and the passes' losses at rtol 1e-4,
   atol 1e-5, the last step's gradients at rtol 1e-4, atol 1e-6. Then
   TRAINER["epochs"] epochs of two shuffled steps with the counters at 0
   (diag_kernel 3 a step and 2 an epoch-0 eval batch, pool_bwd_kernel 1 a
   step; each train pass's launches a step, by form, the dense phase's), no
   host sync in any train pass (torch.cuda's sync debug mode over the pass's
   loop), the first epoch profiled (profile_dir: device busy time from its
   trace, the idle share), the train-pass time a step of the later epochs
   beside the dense phase's bare loop and the loader's collate seconds a
   batch; last the checkpoint it wrote, reloaded by
   ``Trainer(GINetDense, dataset_test=..., pretrained_model=...)`` on the
   card, whose ``test()`` outputs equal the trained model's at rtol 1e-6,
   atol 1e-7 (``trainer_phase``, which every Trainer phase below shares);
43-45. trainer_bcsr, trainer_clustered_bcsr and trainer_blocked:
   GINetBlockSparse(38, 2, 6) and VanillaNetworkBlocked(38, 2, 6) on
   geometric_entry(n, 38, 6, seed=s), GINetClusteredBlockSparse(38, 2, 1)
   (slot8) on clustered_entry(n, 38, 1, seed=s), for (n, s) in
   TRAINER_ATOMIC["sizes"] (60k to 100k nodes), one graph a batch, so the
   Trainer's grow-only buckets grow over the run. The clustered entries
   carry their generator's cluster ids; the in-memory Trainer checks them in
   place of ``_precluster``, which writes HDF5. The three parts of phase 42:
   card against CPU over one dropout-free epoch of two 20k-node entries
   (logits and losses at CROSS_TOL, the last step's gradients at the bare
   phase's CLUSTERED_GRAD_TOL), then TRAINER_ATOMIC["epochs"] shuffled
   epochs with the counters at 0 (a step: K5 int8/float32 4; K5 4, K3 1,
   K4 1; K6f 2, K6b 2; an epoch-0 eval batch K5 2; K5 2, K3 1; K6f 2), no
   host sync in a train pass, epoch 1 profiled, the train-pass time a step
   beside the bare phase's step, the collate seconds and batch megabytes a
   batch, and the buckets at the end equal to the grow-only rounding of the
   entries' requirements (``blocksparse_requirements``,
   ``clustered_blocksparse_requirements``, ``blocked_requirements``); last
   the checkpoint reloaded on the card;
46. trainer_sgat_bcsr, trainer_foutnet_bcsr: SGATBlockSparse (bf16 weighted
   blocks) and FoutNetBlockSparse through the Trainer, card against CPU on
   the two 20k-node clustered entries (gradients at SGAT_FOUTNET_GRAD_TOL),
   launches by form (K5 bfloat16/float32 or int8/float32 4 a step), the
   checkpoint reloaded; not timed;
47. padded_kernels_vs_plain: K5 (int8 and bf16 blocks, both forms; the order
   loop bit for bit on 0/1 blocks), K3, K4 (exact), K6f and K6b against
   their plain versions on the 60k-node entries collated at the buckets
   phases 43-45 ended with, padding tiles, blocks, slabs and member slots
   present, at the tolerances of phases 8 and 11;
48. trainer_dense_family: GINetClusteredDense(38, 2, 1), FoutNetDense and
   SGATDense (edge-weighted) through the Trainer on
   ppi_clustered_entries(512, 160, 38, seed=0) in batches of 256: card
   against CPU over one dropout-free epoch, then two epochs timed as in
   phase 43; batched products only, so every kernel counter stays 0;
49. ginet_dense_batched: GINetDense(38, 2, 6) on DENSE_BATCHED["graphs"]
   graphs of N = K1's max_nodes(int8) + 32 nodes, which takes the batched
   branch: one step against the CPU's batched branch (its batch without
   the flat route's operands) at the dense step's tolerances, with every
   kernel counter at 0.
50. cnn: CnnClassification(33, (35, 30, 30)) on one batch of 128 grids
   of the reference grid protocol (ops/synthetic.py:grid_arrays, seed 7),
   resident on the card, with cuDNN's TF32 switch at PyTorch's default
   (on; this script turns it off elsewhere): one step against the CPU
   (logits and loss at CROSS_TOL; every gradient of the card against the
   network in float64 at tools/f64_gate.py's per-entry gate, relu and
   max-pool winner flips held to their band; the CPU's row reported beside
   it), then CNN["steps"] steps (CNN["warm"] warm) with Adam lr 1e-3 wd 1e-5
   and CrossEntropy, 3 of them profiled (the largest device items), each
   conv's forward, data-gradient and weight-gradient calls timed apart
   (cnn_conv_calls: events, device time, the kernels' names), the step
   beside its bound (cnn_bound: the HBM floor of tests/perf/cnn_perf.py
   against the f32 operations), 0 host syncs; every kernel counter 0;
51. cnn_regression: CnnRegression on the same batch, one step against the
   CPU as in phase 50, with MSE;
52. cnn_ties: both CNNs on CNN_TIES["grids"] grids whose outer
   CNN_TIES["shell"] voxels are 0 (mapped features vanish far from atoms),
   conv biases made positive: whole pooling windows tie (counted in
   float64), and the step against the CPU and float64 as in phase 50 holds
   the gradients that depend on which element wins;
53. trainer_cnn: CnnClassification through Trainer.train on an in-memory
   GridDataset (in_memory_grid_dataset) of TRAINER_CNN["entries"] such
   grids in batches of 128, as phase 42 (trainer_phase): one dropout-free
   epoch of one batch card against CPU (its one step's gradients against
   float64 at the per-entry gate), TRAINER_CNN["epochs"] shuffled epochs
   with every counter 0 and 0 host syncs a train pass, epoch 1 profiled,
   the train pass beside phase 50's bare step, the collate seconds and
   batch megabytes, and the checkpoint reloaded on the card;
54. alignment_gnn: AlignmentGNN (widths ALIGNMENT: hidden 64, message 32,
   MLP 64, edge projection 16, output 2, 3 layers; no published
   configuration) on the bench entries as one graph (81,920 nodes, the
   pairs both ways: 637,016 edges), forward and backward for seeded
   cotangents: outputs and attention card against CPU and float64 at
   CROSS_TOL, the card's every gradient against float64 at the per-entry
   gate with tools/f64_gate.py:alignment_sums' sums of |terms|, every
   counter 0, and the pass timed.

55. native_host_kernels: the featurization's host kernels
   (csrc/{pdb_parser,sasa,grid_kernels}.cpp, built with g++ at first use,
   their build seconds) against their plain versions on every structure of
   tests/data/pdb/, in spawned worker processes side by side: the parser
   field for field (tests/utils/test_pdb_native.py:21-29), SASA of every
   atom at atol 1e-10 (test_sasa_native.py:24), the Gaussian grid kernel on
   at most NATIVE_GRID_POINTS atoms over the protocol's 1 A box at
   np.allclose's defaults (tests/utils/test_grid.py) and over a 30 A box at
   that gate widened by the plain version's own f32 distance error
   (utils/grid.py:_kernel_gaussian_ref_tolerance), with each one's times;
56-57. featurize_ppi and featurize_srv: the reference featurization
   protocols, not cut (FEATURIZE_PPI: tests/perf/ppi_perf.py:16-17 on the
   seven two-chain PPI structures of PPI_STRUCTURES; FEATURIZE_SRV:
   tests/perf/srv_perf.py:37-60), each query as QueryCollection.process
   would (featurize: the build, then the grid; no HDF5 write, as this
   machine has no h5py), one at a time: nodes, edges, build ms, ms of each
   feature module, grid ms, the median and queries a second, the graphs'
   sizes against FEATURIZED_SIZES, every value finite, every channel of
   the grid's shape;
58. trainer_featurized: the PPI tutorial's data on the same structures
   (TRAINER_FEATURIZED: residue graphs at 8 A with components and contact,
   35x30x30 grids with 3 augmentations each, drawn from ``random`` seeded
   0), turned into the entries the datasets would load from the file
   (graph_entry, grid_entry; a CPU test holds them equal to the round
   trip), then through Trainer.train as phase 42 (trainer_phase), 3
   epochs each: VanillaNetwork on res_type and distance, batches of 8 (K7
   2 a step and 2 an eval batch, asserted; gradients at
   CLUSTERED_GRAD_TOL), and CnnClassification on the grids' 35 channels,
   batches of 8 (its one checked step's gradients against float64 at the
   per-entry gate; a max-pool winner may flip up to its chain's
   first-order bound, f64_gate.cnn_chain_terms, since on these nearly
   constant grids the f32 convolutions sit beyond the band C).

59. gp_kernels_vs_plain: K5 at the graph-parallel shapes of
   geometric_entry(100_000, 38, 6) over PARALLEL["ranks"] ranks: each
   rank's row slice (collate_graphs_blocksparse_partitioned: its row tiles,
   every source column) and each rank's ring buckets
   (collate_graphs_blocksparse_ring: the diagonal one and the off-diagonal
   ones, columns re-based to one rank's block), at F=32 and 64 (the two
   layers' widths), against bcsr_spmm_kernel_ref at TOL and against
   bcsr_spmm_order_ref bit for bit; then rank 0's calls timed, beside the
   plain version, cuSPARSE and the bound (time_bcsr_calls), counted four
   times a step (two layers, forward and backward);
60-64. the parallel paths, PARALLEL["ranks"] ranks as processes of one
   gloo group on this one card (parallel/launch.py, one spawn for all,
   the kernels built above first; gloo's point-to-point exchange takes
   host tensors, so the rings' hops pass through pinned host memory):
   60, dryrun_multichip (tools/dryrun_multichip.py's paths: six
   data-parallel layouts, the edge partition and its ring, the BCSR
   partition and its ring, each rank's predictions against the same model
   on one rank within 1e-4, and the comm lines); 61, dp_dense: GINetDense
   data-parallel (parallel/dp.py's step) at the bench shape
   (PARALLEL["dp_graphs"] graphs a rank), PARALLEL["warm"] warm and
   PARALLEL["steps"] timed train steps, max_err of the eval step against
   one rank; 62-64, through Trainer.train, dropout-free: trainer_gp and
   trainer_ring, GINetBlockSparseGP and GINetBlockSparseRing on the
   100k-node graph (one step an epoch, PARALLEL["warm"] +
   PARALLEL["steps"] epochs; paths gp_bcsr and gp_ring), and trainer_dp,
   Trainer(data_parallel=True) on in-memory entries (TRAINER's,
   batch_size TRAINER["batch_size"]), PARALLEL["trainer_epochs"] epochs.
   Each Trainer run's first step is held against the single-device model
   (GINetBlockSparse, GINetDense) with the same initial parameters on
   the whole batch on one rank: its logits within PARALLEL_TOL, its
   gradients after the all-reduce within PARALLEL_TOL of the largest.
   Every parallel run ends with the parameters equal on both ranks, bit
   for bit. Each with its step times (the card synchronised around each
   step), its launches by kernel and form a rank, and its collectives'
   counts and bytes.

65. accuracy_parity: the accuracy-parity twin
   (deeprank2_tpu_torch/tools/accuracy_parity.py) over the whole vendored
   corpus: the PPI (residue, atom, grid) and SRV flavors featurized in
   memory (store="memory": no file, no h5py), then all twelve
   configurations, PARITY["epochs"] epochs, no folds, each port Trainer on
   the card against the torch mirror of the reference math on the CPU
   (ginet_edgepart_ba over PARITY["ranks"] ranks sharing the card over
   gloo). One line a configuration: entries, seconds, launches by kernel
   (rank 0's for the edge partition), the loss trajectories and the
   metrics of both sides, and the gates of PARITY_GATES, each enforced:
   the synced one-epoch probe, the free-running losses (relative) and the
   final metrics. Every kernel of PARITY_KERNELS must launch.

Phases 50-58 launch no kernel of K1-K9 but K7 in phase 58 and add nothing
to the ``kernels`` line; phases 59-65 add their launches (rank 0's in the
parallel runs) and K5's timed slices. Then the ``kernels`` line (every kernel with forms also by form),
the card's name and power limit, and last ``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without CUDA, or without the package beside this file, it exits non-zero
before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

START = time.perf_counter()
HERE = Path(__file__).resolve().parent
STEPS = 20
WARM_STEPS = 4
CLUSTERED_STEPS = 20
MIXED_STEPS = 6
BCSR_STEPS = 20
SEGMENT_STEPS = 20
SYNC_PROBE_STEPS = 10
BCSR = {"nodes": 100_000, "feat": 38, "edge_dim": 6, "seed": 0}
CLUSTERED_BCSR = {"nodes": 100_000, "feat": 38, "edge_dim": 1, "seed": 0, "slot8": True}
BENCH = {"num_graphs": 512, "nodes": 160, "feat": 38, "edge_dim": 6, "seed": 7}
CLUSTERED = {"num_graphs": 512, "nodes": 160, "feat": 38, "seed": 0}
MIXED_CELL = 6.0
# the Trainer's phase: entries of synthetic_entries(..., seed=BENCH["seed"]),
# batch size, epochs of the timed run (its first is profiled) and the
# entries of the card-against-CPU epoch and of the checkpoint reload
TRAINER = {"entries": 1024, "batch_size": 512, "epochs": 3, "check_entries": 512}
# the atomic-resolution Trainer phases: one graph a batch, (nodes, seed) of
# the timed entries (the buckets grow over them) and of the CPU-checked ones
TRAINER_ATOMIC = {"sizes": ((60_000, 1), (80_000, 2), (100_000, 0), (100_000, 3)), "check_sizes": ((20_000, 5), (20_000, 6)), "epochs": 2}
DENSE_FAMILY = {"entries": 512, "batch_size": 256, "epochs": 2}
# the parallel phases 59-64: ranks sharing the card; GINetDense's bench
# batch split over them; train steps timed after warm ones; the Trainer's
# epochs
PARITY = {"epochs": 2, "folds": 0, "ranks": 2}
# the twin's gates (tests/tools/test_accuracy_parity.py's metric gate; the
# losses and the synced probe relative)
PARITY_GATES = {"synced_epoch_rel_delta": 1e-4, "max_loss_delta_rel": 1e-3, "metrics": {"rtol": 1e-2, "atol": 1e-3}}
PARITY_KERNELS = ("diag_kernel", "pool_bwd_kernel", "slot_fwd_kernel", "slot_bwd_kernel", "bcsr_spmm_kernel", "blocked_fwd_kernel", "blocked_bwd_kernel", "segment_sum_sorted_kernel")
PARALLEL = {"ranks": 2, "dp_graphs": 256, "warm": 1, "steps": 2, "trainer_epochs": 2, "timeout_s": 300, "deadline_s": 600}
DENSE_BATCHED = {"graphs": 32}  # GINetDense graphs of N = K1's max_nodes + 32
# the grid path: the reference grid protocol (tests/perf/cnn_perf.py:37-86:
# 33 features, a 35x30x30 box, batches of 128; grid_arrays' recipe), 16
# timed steps after 4 warm; the tied-window check on fewer zero-shell grids;
# the Trainer's grid branch on 256 grids (two batches an epoch)
CNN = {"batch": 128, "features": 33, "box": (35, 30, 30), "seed": 7, "steps": 20, "warm": 4}
CNN_TIES = {"grids": 32, "shell": 6}
TRAINER_CNN = {"entries": 256, "batch_size": 128, "epochs": 3}
# AlignmentGNN on the bench entries' graph: widths chosen for the check (no
# published configuration exists); timed forward/backward passes
ALIGNMENT = {"hidden": 64, "message": 32, "mlp": 64, "edge_projection": 16, "output": 2, "layers": 3, "seed": 7, "timed": 5}
# the featurization phases 55-58 (the card's machine's host CPU; no kernel
# of K1-K9): the vendored structures (tests/data/pdb/); the two-chain PPI
# structures the JAX package's tests query, with their chains; the
# reference featurization protocols, not cut (tests/perf/ppi_perf.py:16-17:
# atom graphs at 5.5 A, six modules, a 35x30x30 Gaussian grid over a 1 A
# box; tests/perf/srv_perf.py:37-60: residue graphs at the 10 A default
# around eight residues of 101M chain A, no irc, the same grid); and the PPI
# tutorial's settings for training (tutorials/data_generation_ppi.py:65,
# 84-85: residue graphs at 8 A with components and contact, the grid with 3
# augmentations a structure; tutorials/training.py: the res_type and
# distance features, batches of 8, 3 epochs here)
DATA = HERE / "tests" / "data"
PPI_STRUCTURES = (
    ("1ATN/1ATN_1w", ("A", "B")),
    ("1ATN/1ATN_2w", ("A", "B")),
    ("1ATN/1ATN_3w", ("A", "B")),
    ("1ATN/1ATN_4w", ("A", "B")),
    ("3C8P/3C8P", ("A", "B")),
    ("3MRC/3MRC", ("M", "P")),
    ("1ak4/1ak4", ("C", "D")),
)
GRID = {"points": (35, 30, 30), "sizes": (1.0, 1.0, 1.0)}
FEATURIZE_PPI = {"resolution": "atom", "cutoff": 5.5, "modules": ("components", "contact", "exposure", "irc", "secondary_structure", "surfacearea")}
FEATURIZE_SRV = {"pdb": "101M/101M", "chain": "A", "residues": (20, 25, 27, 64, 89, 101, 118, 136), "modules": ("components", "contact", "exposure", "secondary_structure", "surfacearea")}
TRAINER_FEATURIZED = {"radius": 8.0, "modules": ("components", "contact"), "augmentations": 3, "node_features": ("res_type",), "edge_features": ("distance",), "batch_size": 8, "epochs": 3, "seed": 0}
# (nodes, edges) of each featurized graph, from the same featurization on a
# CPU without the card (deterministic: no draw, exact cutoffs)
FEATURIZED_SIZES = {
    "1ATN/1ATN_1w:A-B": (361, 3617),
    "1ATN/1ATN_2w:A-B": (315, 3075),
    "1ATN/1ATN_3w:A-B": (379, 4045),
    "1ATN/1ATN_4w:A-B": (148, 973),
    "3C8P/3C8P:A-B": (46, 429),
    "3MRC/3MRC:M-P": (241, 2664),
    "1ak4/1ak4:C-D": (152, 1531),
    "101M/101M:A:20": (25, 228),
    "101M/101M:A:25": (43, 524),
    "101M/101M:A:27": (40, 454),
    "101M/101M:A:64": (42, 465),
    "101M/101M:A:89": (39, 388),
    "101M/101M:A:101": (36, 371),
    "101M/101M:A:118": (34, 341),
    "101M/101M:A:136": (37, 386),
}
# the native host kernels' check on each structure: the parser on the
# whole file, every atom's SASA, at most this many atoms mapped to the grids
NATIVE_GRID_POINTS = 256
CKPT_TOL = {"rtol": 1e-6, "atol": 1e-7}
TOL = {"rtol": 1e-5, "atol": 1e-5}
EXACT = {"rtol": 0.0, "atol": 0.0}
STEP_TOL = {"rtol": 1e-4, "atol": 1e-6}
CROSS_TOL = {"rtol": 1e-4, "atol": 1e-5}
PARALLEL_TOL = 1e-4  # a parallel path's outputs against one rank (the JAX dry run's gate)
CLUSTERED_GATE = 1e-3  # tests/perf/clustered_parity.py:93
SGAT_FOUTNET_GATE = 1e-4  # the FoutNet and sGAT fast paths' logits and head gradients against the f64 COO oracle
# the FoutNet and sGAT steps against the CPU: their conv gradients sum
# weighted products over 10^5 nodes, and on an H100 one entry of sGAT's
# (5.2e-3) moved by 2.0e-6 with the summation order
SGAT_FOUTNET_GRAD_TOL = {"rtol": 1e-4, "atol": 1e-5}
SGAT_FOUTNET_STEPS = 20
SGAT_FOUTNET_CHECK_NODES = 20_000
CLUSTERED_TOL = {"rtol": 1e-4, "atol": 1e-5}
# the bf16 paths' steps against the CPU: their bf16 forms round values that
# the card and the CPU sum in different orders (the f32 weight products,
# the bf16 GEMMs of GINetDense), so a value can land on the neighbouring bf16
# number; atol is one bf16 step at the tensor's largest magnitude (a bf16
# holds 8 significant bits: one step is 2^-8 to 2^-7 of the value)
BF16_STEP_TOL = {"rtol": 1e-4, "atol_share": 2.0**-7}
# f32 on both sides: the largest gradient error seen on the card is ~3e-7
CLUSTERED_GRAD_TOL = {"rtol": 1e-4, "atol": 1e-6}
# dw_e sums one product per edge (3.3M at the atomic graph) in an order of its
# own: its atol is this share of the sum of the products' absolute values,
# the scale of any f32 summation order's rounding error
DW_TOL = 1e-6
# the bf16 tower forms against their plain versions: both round at the same
# points, but a value about to be rounded that the two sum in other orders
# can land on the neighbouring bf16 number (a flip), which moves what
# follows by at most one bf16 step of that value (2^-8 of it; 2^-7 counting
# an output's own rounding). So each output is held to the f32-order bound
# (rtol 1e-5, atol DW_TOL x the sum of its terms' absolute values) except at
# most FLIP_SHARE of its entries, each within FLIP x (that sum + |value|)
FLIP = 2.0**-7
FLIP_SHARE = 1e-3
KERNELS = (
    "diag_kernel",
    "pool_bwd_kernel",
    "slot_fwd_kernel",
    "slot_bwd_kernel",
    "bcsr_spmm_kernel",
    "blocked_fwd_kernel",
    "blocked_bwd_kernel",
    "segment_sum_sorted_kernel",
    "ginet_tower_fwd_kernel",
    "ginet_tower_bwd_kernel",
    "tower_fwd_kernel",
    "tower_bwd_kernel",
)
# each path's calls of each kernel in one train step: (kernel, mode or slot, F)
STEP_CALLS = {
    "dense": [("diag_kernel", "relu_mask", 32), ("diag_kernel", "relu_mask_pool", 64), ("diag_kernel", "plain", 32), ("pool_bwd_kernel", None, 64)],
    "clustered": [("diag_kernel", "relu_mask", 32), ("diag_kernel", "plain", 32)],
    "clustered_pooled": [("diag_kernel", "relu_mask", 64), ("diag_kernel", "plain", 64)],
    "clustered_slot": [("slot_fwd_kernel", 8, 32), ("slot_bwd_kernel", 8, 32)],
    "clustered_bcsr_slot": [("slot_fwd_kernel", 8, 32), ("slot_bwd_kernel", 8, 32)],
}
# each BCSR path's SpMMs in one train step: (structure field, F, calls)
# (forward of each layer and its VJP, the same SpMM on the cotangent)
BCSR_STEP_CALLS = {
    "bcsr": [("structure", 32, 2), ("structure", 64, 2)],
    "clustered_bcsr": [("structure", 32, 2), ("structure_p", 64, 2)],
}
# each COO path's K7 calls in one train step (forward only: the VJP is a
# gather): (path, rows, F, calls)
SEGMENT_STEP_CALLS = [
    ("coo", "coo", 16, 2),
    ("coo", "coo", 32, 2),
    ("coo_clustered", "coo_clustered", 16, 2),
    ("coo_clustered_pooled", "coo_clustered_pooled", 32, 2),
    ("coo_vanilla", "coo", 32, 2),
]
REPLACES = {
    "diag_kernel": "deeprank2_tpu/ops/diag_spmm.py:113 (_diag_kernel, pallas_call at :188)",
    "pool_bwd_kernel": "deeprank2_tpu/ops/diag_spmm.py:263 (_pool_bwd_kernel, pallas_call at :308)",
    "slot_fwd_kernel": "deeprank2_tpu/ops/pallas_slotpool.py:119 (_fwd_kernel, pallas_call at :176)",
    "slot_bwd_kernel": "deeprank2_tpu/ops/pallas_slotpool.py:129 (_bwd_kernel, pallas_call at :200)",
    "bcsr_spmm_kernel": "deeprank2_tpu/ops/block_sparse.py:535 (_kernel_stream, pallas_call at :760)",
    "blocked_fwd_kernel": "deeprank2_tpu/ops/pallas_vanilla.py:122 (_fwd_kernel, pallas_call at :243)",
    "blocked_bwd_kernel": "deeprank2_tpu/ops/pallas_vanilla.py:145 (_bwd_kernel, pallas_call at :274)",
    "segment_sum_sorted_kernel": "deeprank2_tpu/ops/pallas_segment.py:42 (_kernel, pallas_call at :157)",
    "ginet_tower_fwd_kernel": "deeprank2_tpu/ops/pallas_ginet.py:70 (_fwd_kernel, pallas_call at :170)",
    "ginet_tower_bwd_kernel": "deeprank2_tpu/ops/pallas_ginet.py:82 (_bwd_kernel, pallas_call at :195)",
    "tower_fwd_kernel": "deeprank2_tpu/ops/diag_spmm.py:386 (_tower_fwd_kernel, pallas_call at :489)",
    "tower_bwd_kernel": "deeprank2_tpu/ops/diag_spmm.py:435 (_tower_bwd_kernel, pallas_call at :521)",
}
SOURCES = {
    "diag_kernel": "deeprank2_tpu_torch/csrc/diag_spmm.cu",
    "pool_bwd_kernel": "deeprank2_tpu_torch/csrc/diag_spmm.cu",
    "slot_fwd_kernel": "deeprank2_tpu_torch/csrc/slotpool.cu",
    "slot_bwd_kernel": "deeprank2_tpu_torch/csrc/slotpool.cu",
    "bcsr_spmm_kernel": "deeprank2_tpu_torch/csrc/bcsr_spmm.cu",
    "blocked_fwd_kernel": "deeprank2_tpu_torch/csrc/blocked_edges.cu",
    "blocked_bwd_kernel": "deeprank2_tpu_torch/csrc/blocked_edges.cu",
    "segment_sum_sorted_kernel": "deeprank2_tpu_torch/csrc/segment_sum.cu",
    "ginet_tower_fwd_kernel": "deeprank2_tpu_torch/csrc/ginet_tower.cu",
    "ginet_tower_bwd_kernel": "deeprank2_tpu_torch/csrc/ginet_tower.cu",
    "tower_fwd_kernel": "deeprank2_tpu_torch/csrc/diag_tower.cu",
    "tower_bwd_kernel": "deeprank2_tpu_torch/csrc/diag_tower.cu",
}
LIBRARY = {
    "diag_kernel": "torch.bmm of the adjacency [G,N,N] cast to f32 (int8 0/1 or bf16 weights) with the [G,N,F] slab (contraction only)",
    "pool_bwd_kernel": "torch.bmm of the adjacency [G,N,N] cast to f32 with the [G,N,F] slab (contraction only)",
    "slot_fwd_kernel": "h.view(F, V//slot, slot).amax(2) (also the plain version)",
    "slot_bwd_kernel": None,
    "bcsr_spmm_kernel": "torch.sparse_csr_tensor of the mirrored pairs, f32 values (1, or the bf16/f32 weights), @ x [N, F] (cuSPARSE SpMM)",
    "blocked_fwd_kernel": None,
    "blocked_bwd_kernel": None,
    "segment_sum_sorted_kernel": "buf.index_add_(0, ids clamped to n, msgs) into an [n+1, F] buffer",
    "ginet_tower_fwd_kernel": None,
    "ginet_tower_bwd_kernel": None,
    "tower_fwd_kernel": None,
    "tower_bwd_kernel": None,
}
# published peaks (NVIDIA data sheets; dense, without sparsity): (memory
# bytes/s, f32 FLOP/s outside the tensor cores, bf16 FLOP/s on the tensor
# cores). The SXM part is the default.
PEAKS = {"PCIe": (2.0e12, 51e12, 756e12), "NVL": (3.9e12, 60e12, 835e12), "SXM": (3.35e12, 67e12, 989e12)}


def want_launches(**counts) -> dict:
    """The expected count of every kernel: those named, and 0 for the rest."""
    return {k: counts.get(k, 0) for k in KERNELS}


def emit(obj: dict) -> None:
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - START}
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60
    )
    return out.stdout.strip().splitlines()[0]


def peaks(name: str) -> tuple[str, tuple[float, float, float]]:
    """The part of the H100 that ``name`` names, and its ``PEAKS`` entry."""
    key = next((k for k in ("PCIe", "NVL") if k in name), "SXM")
    return key, PEAKS[key]


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


class Counters:
    """The launch counters of every kernel module."""

    def __init__(self, *modules):
        self.modules = modules

    def reset(self) -> None:
        for m in self.modules:
            m.reset_launches()

    def read(self) -> dict:
        return {k: v for m in self.modules for k, v in m.launches.items()}

    def read_forms(self) -> dict:
        """The nonzero launch counts of every kernel with forms (K1, K2, K5,
        K6f, K6b, K8f, K8b, K9f, K9b) by form, as ``"kernel[form]"``:
        ``"int8/bfloat16"`` (adjacency or block type, then activation type)
        for K1, K2, K5 and the towers, the activation type for K6f and
        K6b."""
        return {f"{k}[{form}]": n for m in self.modules for k, forms in getattr(m, "launches_by_dtype", {}).items() for form, n in forms.items() if n}


class Checks:
    """Each comparison of a kernel with its plain version; raises on the first
    disagreement and keeps the largest error of each kernel."""

    def __init__(self, torch):
        self.torch = torch
        self.errs = dict.fromkeys(KERNELS, 0.0)
        self.form_errs = {}  # (kernel, adjacency or block type) -> largest error
        self.rows = []

    def close(self, kernel, what, got, want, tol, form=None) -> None:
        err = (got.float() - want.float()).abs().max().item() if got.numel() else 0.0
        self.errs[kernel] = max(self.errs[kernel], err)
        row = {"kernel": kernel, "check": what, "max_abs_err": err}
        if form is not None:
            self.form_errs[kernel, form] = max(self.form_errs.get((kernel, form), 0.0), err)
            row["form"] = form
        self.rows.append(row)
        self.torch.testing.assert_close(got, want, **tol, msg=lambda m: f"{kernel} {what}: {m}")

    def close_flips(self, kernel, what, got, want, scale, form) -> None:
        """The bf16 tower forms' gate (FLIP, FLIP_SHARE): f32 order except a
        counted share of flips, each within one bf16 step of the chain."""
        got, want, scale = (t.detach().double() for t in (got, want, scale))
        err = (got - want).abs()
        off = err > 1e-5 * want.abs() + DW_TOL * scale
        e = err.max().item() if err.numel() else 0.0
        self.errs[kernel] = max(self.errs[kernel], e)
        self.form_errs[kernel, form] = max(self.form_errs.get((kernel, form), 0.0), e)
        n_off = int(off.sum().item())
        self.rows.append({"kernel": kernel, "check": what, "form": form, "max_abs_err": e, "off_f32_order": n_off, "entries": off.numel()})
        if n_off > FLIP_SHARE * off.numel() or not bool((err[off] <= FLIP * (scale + want.abs())[off]).all()):
            msg = f"{kernel} {what}: {n_off} of {off.numel()} entries off the f32-order bound (at most {FLIP_SHARE:g}), largest error {e:.3e}"
            raise AssertionError(msg)


def check_diag_kernels(torch, ds, checks, shapes, dev, compute_dtype=None) -> None:
    """diag_kernel and pool_bwd_kernel against their plain versions, directly
    and through the autograd Functions, in the kernel form ``compute_dtype``
    selects. The f32 form's layer VJPs are held against autograd through the
    plain layers; the bf16 form's against the plain kernels on the cotangent
    (its VJP rounds the cotangent to bf16 in the kernel, which autograd
    through a plain layer would not)."""
    cd = compute_dtype
    for tag, adj, mask, feats in shapes:
        form = ds.form_name(adj.dtype, ds.activation_dtype(cd))

        def close(kernel, what, got, want, form=form):
            checks.close(kernel, what, got, want, TOL, form)

        gen = torch.Generator(device=dev).manual_seed(len(checks.rows))
        g, n, _ = adj.shape
        for f in feats:
            x = torch.randn(f, g * n, generator=gen, device=dev)
            close("diag_kernel", f"{tag} plain F={f}", ds.diag_kernel(adj, x, compute_dtype=cd), ds.diag_kernel_ref(adj, x, compute_dtype=cd))
            h_ref = ds.diag_kernel_ref(adj, x, mask, "relu_mask", cd)
            close("diag_kernel", f"{tag} relu_mask F={f}", ds.diag_kernel(adj, x, mask, "relu_mask", cd), h_ref)
            sign, pooled = ds.diag_kernel(adj, x, mask, "relu_mask_pool", cd)
            sign_ref, pooled_ref = ds.diag_kernel_ref(adj, x, mask, "relu_mask_pool", cd)
            close("diag_kernel", f"{tag} relu_mask_pool pooled F={f}", pooled, pooled_ref)
            # the stored sign may differ only where h is zero to summation order
            flips = ((sign != sign_ref) & (h_ref.abs() > TOL["atol"])).sum().item()
            checks.rows.append({"kernel": "diag_kernel", "check": f"{tag} relu_mask_pool sign F={f}", "form": form, "sign_flips_clear_of_zero": flips})
            if flips:
                msg = f"diag_kernel pool-mode sign differs from the plain version at {flips} values clear of zero"
                raise AssertionError(msg)
            g_pool = torch.randn(f, g, generator=gen, device=dev)
            close("pool_bwd_kernel", f"{tag} direct F={f}", ds.pool_bwd_kernel(adj, sign_ref, g_pool, cd), ds.pool_bwd_kernel_ref(adj, sign_ref, g_pool, cd))
            # through the autograd Functions: the layer-1 VJP is diag_kernel
            # plain, the pooled layer's VJP is pool_bwd_kernel
            cot = torch.randn(f, g * n, generator=gen, device=dev)
            for layer, kernel, cotangent in (("diag_layer_t", "diag_kernel", cot), ("diag_layer_pool_t", "pool_bwd_kernel", g_pool)):
                xk = x.clone().requires_grad_(True)
                out_k = getattr(ds, layer)(adj, mask, xk, cd)
                (gk,) = torch.autograd.grad(out_k, xk, cotangent)
                if cd is None:
                    xr = x.clone().requires_grad_(True)
                    out_r = getattr(ds, f"{layer}_ref")(adj, mask, xr)
                    (gr,) = torch.autograd.grad(out_r, xr, cotangent)
                elif layer == "diag_layer_t":
                    out_r = h_ref
                    gr = ds.diag_kernel_ref(adj, cot * (h_ref > 0).float(), compute_dtype=cd)
                else:
                    out_r = pooled_ref
                    gr = ds.pool_bwd_kernel_ref(adj, sign_ref, g_pool, cd)
                close("diag_kernel", f"{tag} {layer} fwd F={f}", out_k.detach(), out_r.detach())
                close(kernel, f"{tag} {layer} vjp F={f}", gk, gr)
    sync(torch, dev)


def slot_operands(torch, f, v, dev, seed, mask=None):
    """Non-negative h with masked lanes zeroed, planted exact ties (three lanes
    of one group at its max) and an all-zero group; the f32 mask row (random
    unless given); a cotangent of the widest pooled shape."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if mask is None:
        mask = (torch.rand(1, v, generator=gen, device=dev) > 0.1).float()
    h = torch.randn(f, v, generator=gen, device=dev).abs()
    h[:, 96:104] = 0.0
    h[:, 200:203] = 5.0
    return h * mask, mask, torch.randn(f, v // 2, generator=gen, device=dev)


def mixed_region_shapes(batch, f) -> list:
    """The slot kernels' operand shapes in a mixed batch's forward: one per
    non-empty size-class region, V = G * region width at that region's stride,
    with the region's own node-mask slice (as diag_depth0_pool cuts it)."""
    g = batch.node_mask.shape[0]
    m3 = batch.node_mask.float()
    shapes, off = [], 0
    for slot, ns in zip((8, 4, 2), batch.region_caps[:3]):
        if ns:
            mask = m3[:, off : off + ns].contiguous().reshape(1, g * ns)
            shapes.append((f"mixed region F={f} V={g * ns}", f, g * ns, mask, (slot,)))
        off += ns
    return shapes


def check_slot_kernels(torch, sp, checks, shapes, dev) -> None:
    """slot_fwd_kernel and slot_bwd_kernel against their plain versions, exact,
    directly and through slot_group_max's autograd. Each shape is (tag, F, V,
    mask row or None for a random one, slots)."""
    for tag, f, v, mask_row, slots in shapes:
        for slot in slots:
            h, mask, cot = slot_operands(torch, f, v, dev, seed=v + slot, mask=mask_row)
            g = cot[:, : v // slot].contiguous()
            pooled = sp.slot_fwd_kernel(h, slot)
            checks.close("slot_fwd_kernel", f"{tag} direct slot={slot}", pooled, sp.slot_fwd_kernel_ref(h, slot), EXACT)
            dh = sp.slot_bwd_kernel(h, mask, pooled, g, slot)
            checks.close("slot_bwd_kernel", f"{tag} direct slot={slot}", dh, sp.slot_bwd_kernel_ref(h, mask, pooled, g, slot), EXACT)
            outs = []
            for fn in (sp.slot_group_max, sp.slot_group_max_ref):
                x = h.clone().requires_grad_(True)
                out = fn(x, mask, slot=slot)
                (grad,) = torch.autograd.grad(out, x, g)
                outs.append((out.detach(), grad))
            checks.close("slot_fwd_kernel", f"{tag} slot_group_max fwd slot={slot}", outs[0][0], outs[1][0], EXACT)
            checks.close("slot_bwd_kernel", f"{tag} slot_group_max vjp slot={slot}", outs[0][1], outs[1][1], EXACT)
    sync(torch, dev)


def card_vs_cpu_step(torch, model, batch, loss_fn, cpu_model_factory, tol, grad_tol, cpu_batch=None) -> tuple[dict, object, object]:
    """One dropout-free step (logits, loss, every gradient) on the model's
    device and on the CPU from the same parameters and batch (``cpu_batch``
    where given, else the batch moved to the CPU). A tolerance may give
    ``atol_share`` instead of ``atol``: that share of the CPU value's
    largest magnitude. Returns the errors, the CPU model and the CPU
    batch."""
    cpu_model = cpu_model_factory()
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_batch = batch.to("cpu") if cpu_batch is None else cpu_batch
    results = []
    for m, b in ((model, batch), (cpu_model, cpu_batch)):
        m.zero_grad(set_to_none=True)
        logits = m(b, training=False)
        loss = loss_fn(logits, b.y, b.y_mask)
        loss.backward()
        results.append((logits.detach().cpu(), loss.detach().cpu(), {k: p.grad.cpu() for k, p in m.named_parameters() if p.grad is not None}))
    model.zero_grad(set_to_none=True)
    (lg, ls, gr), (lc, lsc, grc) = results
    if gr.keys() != grc.keys():
        msg = f"gradients differ in which parameters have one: {sorted(gr)} vs {sorted(grc)}"
        raise AssertionError(msg)
    errs = {}
    for name, got, want, t in [("logits", lg, lc, tol), ("loss", ls, lsc, tol), *[(f"grad {k}", gr[k], grc[k], grad_tol) for k in gr]]:
        if "atol_share" in t:
            t = {"rtol": t["rtol"], "atol": t["atol_share"] * want.abs().max().item()}
        torch.testing.assert_close(got, want, **t, msg=lambda m, name=name: f"card vs CPU {name}: {m}")
        errs[name] = (got - want).abs().max().item()
    return {"loss": ls.item(), "max_abs_err": errs}, cpu_model, cpu_batch


def slot_winner_flips(torch, ds, fg, model, batch, cpu_model, cpu_batch) -> dict:
    """Slot groups of the layer-1 activation whose max-pool winner (first
    max lane) differs between card and CPU: ties to summation-order error.
    A flip is allowed only inside its rounding band: the two lanes' float64
    activations differ by at most c 2^-24 times the sum of their sums of
    |terms| (tools/f64_gate.py); a flip outside it fails."""
    hs = []
    with torch.no_grad():
        for m, b in ((model, batch), (cpu_model, cpu_batch)):
            w1_t = torch.cat([m.conv1["fc"].weight, m.conv1_ext["fc"].weight], dim=0)
            hs.append(ds.diag_layer_t(b.adj_i8, b.node_mask, w1_t @ b.x_t).cpu())
        z, s_z = fg.layer_f64(batch.adj_i8, batch.x_t, torch.cat([model.conv1["fc"].weight, model.conv1_ext["fc"].weight], dim=0).T)
        live = batch.node_mask.reshape(1, -1)
        h64, s64 = (torch.relu(z) * live).cpu(), (s_z * live).cpu()
        del z, s_z
    f = hs[0].shape[0]
    g, n = batch.node_mask.shape
    nb, n4, n2 = batch.region_caps[:3] if batch.region_caps else (n, 0, 0)
    flips, groups, off, in_band, out_of_band = {}, 0, 0, 0, 0
    for slot, ns in ((8, nb), (4, n4), (2, n2)):
        if ns:
            lanes = [t.reshape(f, g, n)[:, :, off : off + ns].reshape(f, g, ns // slot, slot) for t in (*hs, h64, s64)]
            win = [lanes[k].argmax(dim=3) for k in (0, 1)]
            live_groups = lanes[1].amax(dim=3) > 0
            flipped = (win[0] != win[1]) & live_groups
            flips[f"slot{slot}"] = int(flipped.sum())
            groups += int(live_groups.sum())
            at = [torch.gather(lanes[k], 3, w[..., None])[..., 0][flipped] for k in (2, 3) for w in win]  # h64 at a, b; s64 at a, b
            band = (at[0] - at[1]).abs() <= fg.C * fg.UNIT * (at[2] + at[3])
            in_band += int(band.sum())
            out_of_band += int((~band).sum())
        off += ns
    if out_of_band:
        msg = f"{out_of_band} slot winner flips between card and CPU outside their rounding band (c = {fg.C})"
        raise AssertionError(msg)
    return {"groups_with_a_positive_max": groups, "winner_flips": flips, "winner_flips_in_band": in_band}


def run_main_path(torch, counters, model, batch, loss_fn, opt, dev, want, steps, warm=WARM_STEPS, want_forms=None) -> dict:
    """``steps`` train steps and one eval forward, with the launch counters
    set to 0 just before and read just after; ``want`` is the expected count
    of every kernel and ``want_forms``, where given, of every nonzero count
    by form (``"kernel[form]"``, :meth:`Counters.read_forms`)."""
    drop_gen = torch.Generator(device=dev).manual_seed(1)

    def train_step():
        opt.zero_grad(set_to_none=True)
        logits = model(batch, training=True, generator=drop_gen)
        loss = loss_fn(logits, batch.y, batch.y_mask)
        loss.backward()
        opt.step()
        return loss.detach()

    sync(torch, dev)
    counters.reset()
    losses = [train_step() for _ in range(warm)]
    sync(torch, dev)
    t0 = time.perf_counter()
    losses += [train_step() for _ in range(steps - warm)]
    sync(torch, dev)
    step_s = (time.perf_counter() - t0) / (steps - warm)
    with torch.no_grad():
        eval_logits = model(batch, training=False)
    sync(torch, dev)
    launches, forms = counters.read(), counters.read_forms()
    losses = torch.stack(losses).cpu()
    if dev.type == "cuda" and launches != want:
        msg = f"main path launches {launches}, expected {want}"
        raise AssertionError(msg)
    if dev.type == "cuda" and want_forms is not None and forms != want_forms:
        msg = f"main path launches by form {forms}, expected {want_forms}"
        raise AssertionError(msg)
    if not torch.isfinite(losses).all() or not torch.isfinite(eval_logits).all() or tuple(eval_logits.shape) != (batch.num_graphs, 2):
        msg = f"non-finite or misshapen results: losses {losses.tolist()}, logits {tuple(eval_logits.shape)}"
        raise AssertionError(msg)
    return {
        "steps": steps,
        "timed_steps": steps - warm,
        "step_s": step_s,
        "loss_first": losses[0].item(),
        "loss_last": losses[-1].item(),
        "launches": launches,
        "launches_expected": want,
        "launches_by_form": forms,
        "train_step": train_step,
    }


def bound(in_bytes, out_bytes, flop, peak, mma_flop=0) -> dict:
    """The least time of a call: its bytes over the memory rate, or its
    operations, whichever takes longer. ``flop`` counts at the f32 rate
    outside the tensor cores, except ``mma_flop``, the part of it that is
    dense products of bf16 operands with f32 sums (the weight products of a
    bf16 form), at the bf16 tensor-core rate; the two units may run at once."""
    bw, f32, bf16 = peak
    t_bytes, t_ops = (in_bytes + out_bytes) / bw, max((flop - mma_flop) / f32, mma_flop / bf16)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": in_bytes + out_bytes}


def time_diag_calls(torch, ds, timer, path, adj, mask, specs, peak, compute_dtype=None) -> list:
    """Kernel, plain-version and library times of diag_kernel and
    pool_bwd_kernel at one adjacency, with each call's bound (bytes: inputs
    read once, outputs written once; operations: the products this
    adjacency's nonzeros need). The bf16 form is timed on bf16 activations
    (what its path hands it; 2 bytes an entry in the bound), beside its f32
    form on the same values (``f32_form_ms``), and the library call is
    ``torch.bmm`` on bf16 operands."""
    act = ds.activation_dtype(compute_dtype)
    g, n, _ = adj.shape
    adj_lib = adj.to(torch.float32 if act == torch.float32 else torch.bfloat16)
    adj_bytes = adj.numel() * adj.element_size()
    xb = torch.tensor([], dtype=act).element_size()
    nnz = int(adj.count_nonzero().item())
    gen = torch.Generator(device="cuda").manual_seed(11)
    calls = []
    for kernel, mode, f, *per_step in specs:
        x = torch.randn(f, g * n, generator=gen, device="cuda").to(act)
        x_gnf = x.reshape(f, g, n).permute(1, 2, 0).contiguous()
        if kernel == "diag_kernel":
            m = None if mode == "plain" else mask

            def run(x=x, m=m, mode=mode, cd=compute_dtype):
                return ds.diag_kernel(adj, x, m, mode, cd)

            plain = lambda x=x, m=m, mode=mode: ds.diag_kernel_ref(adj, x, m, mode, compute_dtype)  # noqa: E731
            in_bytes = adj_bytes + xb * f * g * n + (0 if mode == "plain" else g * n)
            out_bytes = (f * g * n + 4 * f * g) if mode == "relu_mask_pool" else 4 * f * g * n
        else:
            sign, _ = ds.diag_kernel(adj, x, mask, "relu_mask_pool", compute_dtype)
            g_pool = torch.randn(f, g, generator=gen, device="cuda").to(act)

            def run(sign=sign, g_pool=g_pool, cd=compute_dtype):
                return ds.pool_bwd_kernel(adj, sign, g_pool, cd)

            plain = lambda sign=sign, g_pool=g_pool: ds.pool_bwd_kernel_ref(adj, sign, g_pool, compute_dtype)  # noqa: E731
            in_bytes = adj_bytes + f * g * n + xb * f * g
            out_bytes = 4 * f * g * n
        library = lambda x_gnf=x_gnf: torch.bmm(adj_lib, x_gnf)  # noqa: E731
        flop = 2 * f * nnz
        flop_dense = 2 * f * n * n * g
        extra = {}
        if act != torch.float32:
            f32_args = (x.float(),) if kernel == "diag_kernel" else (sign, g_pool.float())
            extra["f32_form_ms"] = timer.ms(lambda run=run, a=f32_args: run(*a, cd=None))
        calls.append(
            {
                "path": path,
                "kernel": kernel,
                "mode": mode or "pool_bwd",
                "form": ds.form_name(adj.dtype, act),
                "shape": [g, n, n],
                "F": f,
                "per_step": per_step[0] if per_step else 1,
                "ms": timer.ms(run),
                "plain_ms": timer.ms(plain),
                "library_ms": timer.ms(library),
                **extra,
                **bound(in_bytes, out_bytes, flop, peak),
                **mma_floor(torch, ds, kernel, adj.dtype, act, flop_dense, peak),
                "adjacency_nnz": nnz,
                "flop_needed": flop,
                "flop_dense": flop_dense,
            }
        )
    return calls


def mma_floor(torch, ds, kernel, adj_dtype, act, flop_dense, peak) -> dict:
    """Which body of csrc/diag_spmm.cu runs this K1/K2 form (``ds.diag_body``:
    "mma", the tensor cores, or "fma", f32 FMAs on CUDA cores), its passes
    over the dense [N, N] products on the tensor cores (K1's f32 form three,
    one per bf16 piece of x; the bf16 forms one; K2 one, the count product),
    and ``mma_floor_ms``, those passes' dense products at the bf16
    tensor-core peak: beside the bound, it shows whether bytes or dense
    products limit the body. Worked out, not measured: these rows only, not
    the kernels line."""
    body = ds.diag_body(kernel, adj_dtype, act)
    if body == "fma":
        return {"body": body, "passes": None, "mma_floor_ms": None}
    passes = 3 if kernel == "diag_kernel" and act == torch.float32 else 1
    return {"body": body, "passes": passes, "mma_floor_ms": passes * flop_dense / peak[2] * 1e3}


def time_slot_calls(torch, sp, timer, path, mask_row, specs, peak) -> list:
    """Kernel, plain-version and library times of the slot kernels at the
    clustered path's activation width, with each call's byte bound; the
    kernel's and the library call's device times too (``device_ms``,
    ``library_device_ms``: the profiler's, without the host's launch)."""
    v = mask_row.shape[1]
    calls = []
    for kernel, slot, f in specs:
        h, _, cot = slot_operands(torch, f, v, mask_row.device, seed=slot)
        h = h * mask_row
        pooled = sp.slot_fwd_kernel_ref(h, slot)
        g = cot[:, : v // slot].contiguous()
        library = {"library_ms": None}
        if kernel == "slot_fwd_kernel":
            run = lambda h=h, slot=slot: sp.slot_fwd_kernel(h, slot)  # noqa: E731
            plain = lambda h=h, slot=slot: sp.slot_fwd_kernel_ref(h, slot)  # noqa: E731
            amax = lambda h=h, slot=slot: h.view(f, v // slot, slot).amax(2)  # noqa: E731
            library = {"library_ms": timer.ms(amax), "library_device_ms": timer.launch_ms(amax, {"ms": ""})["ms"]}
            in_bytes, out_bytes, ops = 4 * f * v, 4 * f * v // slot, f * v
        else:
            run = lambda h=h, pooled=pooled, g=g, slot=slot: sp.slot_bwd_kernel(h, mask_row, pooled, g, slot)  # noqa: E731
            plain = lambda h=h, pooled=pooled, g=g, slot=slot: sp.slot_bwd_kernel_ref(h, mask_row, pooled, g, slot)  # noqa: E731
            in_bytes, out_bytes, ops = 4 * f * v + 4 * v + 2 * 4 * f * v // slot, 4 * f * v, 3 * f * v
        calls.append(
            {
                "path": path,
                "kernel": kernel,
                "mode": f"slot={slot}",
                "shape": [f, v],
                "F": f,
                "ms": timer.ms(run),
                **timer.launch_ms(run, {"device_ms": ""}),
                "plain_ms": timer.ms(plain),
                **library,
                **bound(in_bytes, out_bytes, ops, peak),
            }
        )
    return calls


def check_bcsr_kernel(torch, bs, checks, shapes, dev, compute_dtype=None) -> None:
    """bcsr_spmm_kernel against its plain version, directly and through
    bcsr_spmm_t's autograd (whose VJP is the same SpMM of the cotangent), in
    the kernel form ``compute_dtype`` selects. int8 0/1 blocks within TOL;
    weighted blocks within rtol 1e-5 and an atol of DW_TOL times the largest
    sum of the products' absolute values (at least TOL's atol): a pooled
    pair's weight sums its member edges' (tens), so a row's products reach
    hundreds and another f32 summation order moves the sum by more than
    1e-5. Signed int8 blocks (``signed_structure``) are held as weighted
    ones."""
    import dataclasses

    cd = compute_dtype
    for tag, st, feats in shapes:
        gen = torch.Generator(device=dev).manual_seed(len(checks.rows))
        form = bs.form_name(st.blocks_t.dtype, bs.activation_dtype(cd))
        st_abs = dataclasses.replace(st, blocks_t=st.blocks_t.abs())
        zero_one = form.startswith("int8/") and bool(st.blocks_t.ge(0).logical_and(st.blocks_t.le(1)).all().item())

        def tol(v, st_abs=st_abs, zero_one=zero_one):
            if zero_one:
                return TOL
            return {"rtol": TOL["rtol"], "atol": max(TOL["atol"], DW_TOL * bs.bcsr_spmm_kernel_ref(st_abs, v.abs()).max().item())}

        for f in feats:
            x = torch.randn(f, st.padded_nodes, generator=gen, device=dev)
            t = tol(x)
            checks.close("bcsr_spmm_kernel", f"{tag} direct F={f}", bs.bcsr_spmm_kernel(st, x, cd), bs.bcsr_spmm_kernel_ref(st, x, cd), t, form)
            checks.rows[-1]["atol"] = t["atol"]
            cot = torch.randn(f, st.padded_rows, generator=gen, device=dev)
            xk = x.clone().requires_grad_(True)
            (grad,) = torch.autograd.grad(bs.bcsr_spmm_t(st, xk, cd), xk, cot)
            t = tol(cot)
            checks.close("bcsr_spmm_kernel", f"{tag} bcsr_spmm_t vjp F={f}", grad, bs.bcsr_spmm_kernel_ref(st, cot, cd), t, form)
            checks.rows[-1]["atol"] = t["atol"]
    sync(torch, dev)


def signed_structure(torch, st, seed):
    """The structure with its int8 0/1 blocks reweighted in {-2, -1, 1, 3}
    (``signed_int8_blocks``: some blocks stay 0/1, the others are mixed; the
    JAX kernel and the plain version take each int8 at its signed value)."""
    import dataclasses

    from deeprank2_tpu_torch.ops.synthetic import signed_int8_blocks

    blocks = signed_int8_blocks(st.blocks_t.cpu().numpy(), st.tile_blocks.cpu().numpy(), seed)
    return dataclasses.replace(st, blocks_t=torch.from_numpy(blocks).to(st.blocks_t.device))


def check_bcsr_order(torch, bs, checks, shapes, dev) -> None:
    """For 0/1 int8 blocks, bcsr_spmm_kernel in both forms against
    ``bs.bcsr_spmm_order_ref``, the float32 loop in the kernel's order
    (block positions in tile_blocks order, then c ascending, one add a
    term) run in torch on the card: bit for bit (``max_abs_diff`` 0.0)."""
    for tag, st, feats in shapes:
        for cd in (None, torch.bfloat16):
            form = bs.form_name(st.blocks_t.dtype, bs.activation_dtype(cd))
            for f in feats:
                x = torch.randn(f, st.padded_nodes, generator=torch.Generator(device=dev).manual_seed(f), device=dev)
                checks.close("bcsr_spmm_kernel", f"{tag} order loop F={f}", bs.bcsr_spmm_kernel(st, x, cd), bs.bcsr_spmm_order_ref(st, x, cd), EXACT, form)
                checks.rows[-1]["max_abs_diff"] = checks.rows[-1]["max_abs_err"]
    sync(torch, dev)


def csr_of(torch, st):
    """The structure's adjacency as a CUDA ``torch.sparse_csr_tensor``
    (the mirrored pairs, ``[padded_rows, padded_nodes]``), with f32 values:
    1 for int8 blocks, the weights of bf16 or f32 ones."""
    k, c, i = st.blocks_t.nonzero(as_tuple=True)
    rows = st.block_row[k].long() * st.block + i
    cols = st.block_col[k].long() * st.block + c
    values = st.blocks_t[k, c, i].float()
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), values, (st.padded_rows, st.padded_nodes))
    return coo.coalesce().to_sparse_csr()


def time_bcsr_calls(torch, bs, timer, path, batch, specs, peak, compute_dtype=None) -> list:
    """Kernel, plain-version and cuSPARSE times of bcsr_spmm_kernel at one
    path's structures, with each call's bound: bytes, the nonzero blocks, x
    and the row-tile index read once and the output written once;
    operations, 2*F per directed edge (the products these edges need). The
    bf16 form is timed on bf16 x (2 bytes an entry in the bound), beside its
    f32 form (``f32_form_ms``); its library call is cuSPARSE on bf16 values
    and x where it takes them, else on f32 (``library_form`` says which).
    ``blocks_read_ms`` is one torch read of the nonzero blocks' bytes (an
    f32 sum over a contiguous copy of them, their bits taken as f32): what
    streaming the blocks alone takes on this card, beside the byte bound."""
    act = bs.activation_dtype(compute_dtype)
    gen = torch.Generator(device="cuda").manual_seed(12)
    calls = []
    for name, f, per_step in specs:
        st = getattr(batch, name)
        csr = csr_of(torch, st)
        nnz = csr._nnz()
        real = st.tile_blocks.numel()
        x = torch.randn(f, st.padded_nodes, generator=gen, device="cuda").to(act)
        x_rows = x.T.contiguous()
        lib_form = "float32"
        if act != torch.float32:
            try:
                csr_b = csr.to(act)
                (csr_b @ x_rows).sum().item()
                csr, lib_form = csr_b, "bfloat16"
            except RuntimeError as e:  # cuSPARSE refused bf16: the f32 call is the yardstick
                lib_form = f"float32 (bf16 refused: {str(e).splitlines()[0][:120]})"
                x_rows = x_rows.float()
        blocks_nz = st.blocks_t[st.tile_blocks.long()].view(torch.float32)
        extra = {"library_form": lib_form, "blocks_read_ms": timer.ms(lambda b=blocks_nz: b.sum())}
        del blocks_nz
        if act != torch.float32:
            extra["f32_form_ms"] = timer.ms(lambda st=st, x32=x.float(): bs.bcsr_spmm_kernel(st, x32))
        in_bytes = real * st.block**2 * st.blocks_t.element_size() + x.element_size() * f * st.padded_nodes + 4 * (2 * real + st.tile_ptr.numel())
        # source nodes (block rows) with an edge into the row tile: the share
        # of the dense product that meets a nonzero
        rows_share = st.blocks_t[st.tile_blocks.long()].ne(0).any(dim=2).float().mean().item() if real else 0.0
        calls.append(
            {
                "path": path,
                "kernel": "bcsr_spmm_kernel",
                "mode": name,
                "form": bs.form_name(st.blocks_t.dtype, act),
                "shape": {"blocks_stored": st.num_blocks, "blocks_nonzero": real, "chunks": st.num_chunks, "nodes": st.padded_nodes},
                "F": f,
                "per_step": per_step,
                "ms": timer.ms(lambda st=st, x=x: bs.bcsr_spmm_kernel(st, x, compute_dtype)),
                "plain_ms": timer.ms(lambda st=st, x=x: bs.bcsr_spmm_kernel_ref(st, x, compute_dtype)),
                "library_ms": timer.ms(lambda csr=csr, x_rows=x_rows: csr @ x_rows),
                **extra,
                **bound(in_bytes, 4 * f * st.padded_rows, 2 * f * nnz, peak),
                "directed_edges": nnz,
                "flop_dense": 2 * f * real * st.block**2,
                "nonzero_source_rows_share": rows_share,
            }
        )
        del csr
    return calls


def blocked_operands(torch, st, m, dev, seed):
    """Random ``xr``, ``xc`` [padded_nodes, M], ``w_e`` [Fe, M] and a cotangent ``g``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    xr, xc, g = (torch.randn(st.padded_nodes, m, generator=gen, device=dev) for _ in range(3))
    return xr, xc, torch.randn(st.edge_dim, m, generator=gen, device=dev), g


def check_blocked_kernels(torch, be, vn, checks, shapes, dev, compute_dtype=None) -> None:
    """blocked_fwd_kernel and blocked_bwd_kernel against their plain versions,
    directly and through blocked_message_sum's autograd Function, in the
    kernel form ``compute_dtype`` selects (kernel and plain version round at
    the same points, on bit-identical pre-activations); out, dxr and dxc
    also against ``vn.blocked_order_ref``, the float32 loop in ascending slot
    order, bit for bit (``max_abs_diff`` 0.0); a structure without edges must
    give exact zeros."""
    cd = compute_dtype
    form = vn.dtype_name(vn.activation_dtype(cd))
    for tag, st, ms in shapes:
        for m in ms:
            xr, xc, w_e, g = blocked_operands(torch, st, m, dev, seed=len(checks.rows))
            dw_tol = {"rtol": 1e-5, "atol": DW_TOL * vn.dw_error_scale(st, g, cd).max().item() + 1e-6}
            want_out = vn.blocked_fwd_kernel_ref(st, xr, xc, w_e, cd)
            want = vn.blocked_bwd_kernel_ref(st, xr, xc, w_e, g, cd)
            args = [t.clone().requires_grad_(True) for t in (xr, xc, w_e)]
            out_fn = be.blocked_message_sum(st, *args, compute_dtype=cd)
            grads = torch.autograd.grad(out_fn, args, g)
            direct = (vn.blocked_fwd_kernel(st, xr, xc, w_e, cd), vn.blocked_bwd_kernel(st, xr, xc, w_e, g, cd))
            order = vn.blocked_order_ref(st, xr, xc, w_e, g, cd)
            for name, got, want_o in zip(("out", "dxr", "dxc"), (direct[0], *direct[1][:2]), order):
                checks.close("blocked_fwd_kernel" if name == "out" else "blocked_bwd_kernel", f"{tag} order loop {name} M={m}", got, want_o, EXACT, form)
                checks.rows[-1]["max_abs_diff"] = checks.rows[-1]["max_abs_err"]
            for how, (out, (dxr, dxc, dw_e)) in (("direct", direct), ("blocked_message_sum", (out_fn.detach(), grads))):
                checks.close("blocked_fwd_kernel", f"{tag} {how} out M={m}", out, want_out, TOL, form)
                checks.close("blocked_bwd_kernel", f"{tag} {how} dxr M={m}", dxr, want[0], TOL, form)
                checks.close("blocked_bwd_kernel", f"{tag} {how} dxc M={m}", dxc, want[1], TOL, form)
                checks.close("blocked_bwd_kernel", f"{tag} {how} dw_e M={m}", dw_e, want[2], dw_tol, form)
                checks.rows[-1]["atol"] = dw_tol["atol"]
                if not st.edge_order.numel() and any(t.any() for t in (out, dxr, dxc, dw_e)):
                    msg = f"{tag}: a structure without edges gave nonzero results"
                    raise AssertionError(msg)
            del want, want_out, out_fn, grads, direct, order
    sync(torch, dev)


def edge_read_bytes(torch, st) -> dict:
    """Bytes read per real edge from the edge arrays. ``slot_read``: the 32 B
    sectors a read through the edge slots touches (the earlier kernels'), a
    warp loading 32 of one node's edges at a time through ``edge_order`` (4 B
    an edge, contiguous), then per edge slot ``col_local``, ``sub_col`` and
    the Fe rows of ``eattr_t``: the distinct sectors of each 32-edge load,
    counted on this structure.
    ``stream_read``: the destination-ordered stream, its source node and its
    ``fe_pad`` features (contiguous). ``bound_counts``: what the bound counts
    (8 + 4·Fe)."""
    ptr, order = st.row_ptr.long(), st.edge_order.long()
    edges, fe = order.numel(), st.edge_dim
    out = {"bound_counts": 8 + 4 * fe, "stream_read": st.edge_src.element_size() + st.edge_feat.element_size() * st.edge_feat.shape[1]}
    if not edges:
        return {**out, "slot_read": 0.0}
    i = torch.arange(edges, device=order.device)
    start = ptr[:-1].repeat_interleave(ptr[1:] - ptr[:-1])
    first = start + (i - start) // 32 * 32  # the first edge of each edge's 32-edge load

    def sectors(sector):
        return torch.unique(first * 2**24 + sector).numel()

    touched = sectors(order >> 3) * (1 + fe) + sectors(order >> 11)
    return {**out, "slot_read": 4 + 32 * touched / edges}


def time_blocked_calls(torch, vn, timer, path, st, m, per_step, peak, compute_dtype=None) -> list:
    """Kernel and plain-version times of K6f and K6b at one structure, with
    each call's bound. Bytes: the real edges' index (8 B) and features
    (4·Fe B; the stream the kernels read holds 4 + 4·Fe_pad), row_ptr,
    sub_col, w_e and the node arrays read once, the outputs written once.
    Operations, per real edge and feature: 2·Fe + 4 forward (the edge term, two adds, the relu, the
    sum), 4·Fe + 8 backward (the edge term, both pre-activations, two
    selects and sums, dw_e's multiply-adds). No single PyTorch call computes
    either function. The bf16 form is timed on bf16 operands (2 bytes a node
    entry in the bound; the edge features stay f32), beside its f32 form
    (``f32_form_ms``); its products of bf16 operands with f32 sums (the edge
    term, 2·Fe, and dw_e's, 2·Fe) count at the bf16 tensor-core rate.
    ``warm_ms``: the same calls back to back, without the L2 flush;
    ``edge_bytes_per_edge``: :func:`edge_read_bytes`."""
    cd = compute_dtype
    act = vn.activation_dtype(cd)
    ops32 = blocked_operands(torch, st, m, "cuda", seed=13)
    xr, xc, w_e, g = (t.to(act) for t in ops32)
    edges, fe = st.edge_order.numel(), st.edge_dim
    ab = xr.element_size()
    shared = edges * (8 + 4 * fe) + 4 * (st.row_ptr.numel() + st.sub_col.numel()) + ab * fe * m
    node_in, node_out = ab * st.padded_nodes * m, 4 * st.padded_nodes * m
    specs = (
        ("blocked_fwd_kernel", lambda c: vn.blocked_fwd_kernel(st, *((xr, xc, w_e) if c else ops32[:3]), c),
         lambda: vn.blocked_fwd_kernel_ref(st, xr, xc, w_e, cd), shared + 2 * node_in, node_out, 2 * fe + 4, 2 * fe),
        ("blocked_bwd_kernel", lambda c: vn.blocked_bwd_kernel(st, *((xr, xc, w_e, g) if c else ops32), c),
         lambda: vn.blocked_bwd_kernel_ref(st, xr, xc, w_e, g, cd), shared + 3 * node_in, 2 * node_out + 4 * fe * m, 4 * fe + 8, 4 * fe),
    )  # fmt: skip
    shape = {"nodes": st.padded_nodes, "real_edges": edges, "edge_slots": st.row_local.numel(), "edge_dim": fe}
    read = edge_read_bytes(torch, st)
    return [
        {
            "path": path,
            "kernel": kernel,
            "mode": "message sum",
            "form": vn.dtype_name(act),
            "shape": shape,
            "F": m,
            "per_step": per_step,
            "ms": timer.ms(lambda run=run: run(cd)),
            "warm_ms": timer.ms(lambda run=run: run(cd), flush=False),
            "plain_ms": timer.ms(plain),
            "library_ms": None,
            "edge_bytes_per_edge": read,
            **({"f32_form_ms": timer.ms(lambda run=run: run(None))} if cd is not None else {}),
            **bound(in_bytes, out_bytes, ops * m * edges, peak, 0 if cd is None else mma * m * edges),
            "flop_needed": ops * m * edges,
        }
        for kernel, run, plain, in_bytes, out_bytes, ops, mma in specs
    ]


def sync_sites(caught) -> list:
    """The Python line of each host sync that torch.cuda's sync debug mode
    warned of. Its notice, once a process, that the mode is a prototype
    ("does not yet detect all synchronizing operations") is no sync."""
    return [f"{Path(w.filename).name}:{w.lineno}" for w in caught if "synchroniz" in str(w.message) and "prototype feature" not in str(w.message)]


def profile_steps(torch, train_step, step_s, steps=3) -> dict:
    """Device time by kernel over a few traced train steps. The idle share is
    taken against the untraced step time (tracing slows the host) and, for
    comparison, against the traced wall time. One more step runs under
    torch.cuda's sync debug mode, which counts the operations that make the
    host wait for the device."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            train_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # operations that wait for the device, in one more step
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            train_step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = sync_sites(caught)
    # device-side events only; user annotations (e.g. Optimizer.step) span gaps between kernels
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA" and not e.is_user_annotation and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    return {
        "steps": steps,
        "traced_wall_us_per_step": wall_us / steps,
        "untraced_step_us": step_s * 1e6,
        "device_busy_us_per_step": busy_us / steps,
        "idle_share": max(0.0, 1 - busy_us / steps / (step_s * 1e6)),
        "idle_share_traced": max(0.0, 1 - busy_us / wall_us),
        "host_syncs_per_step": len(syncs),
        "host_sync_sites": {site: syncs.count(site) for site in sorted(set(syncs))},
        "top": [{"name": e.key[:90], "device_us_per_step": e.self_device_time_total / steps, "launches_per_step": e.count / steps} for e in top],
    }


def check_segment_kernel(torch, ss, checks, shapes, dev) -> None:
    """segment_sum_sorted_kernel against its plain version, directly and
    through segment_sum_sorted's autograd (its VJP is a gather), on random
    messages (relu'd where the caller's are); the padding entries' messages
    are not zero, so a kernel that read them would disagree. Segments without
    a message must give exact zeros."""
    for tag, rows, n, f, relu in shapes:
        gen = torch.Generator(device=dev).manual_seed(len(checks.rows))
        msgs = torch.randn(rows.shape[0], f, generator=gen, device=dev)
        if relu:
            msgs = msgs.relu()
        cot = torch.randn(n, f, generator=gen, device=dev)
        want = ss.segment_sum_sorted_kernel_ref(msgs, rows, n)
        out = ss.segment_sum_sorted_kernel(msgs, rows, n)
        checks.close("segment_sum_sorted_kernel", f"{tag} direct F={f}", out, want, TOL)
        grads = []
        for fn in (ss.segment_sum_sorted, ss.segment_sum_sorted_kernel_ref):
            m = msgs.clone().requires_grad_(True)
            got = fn(m, rows, n)
            grads.append((got.detach(), torch.autograd.grad(got, m, cot)[0]))
        checks.close("segment_sum_sorted_kernel", f"{tag} segment_sum_sorted fwd F={f}", grads[0][0], want, TOL)
        checks.close("segment_sum_sorted_kernel", f"{tag} segment_sum_sorted vjp F={f}", grads[0][1], grads[1][1], TOL)
        counts = torch.zeros(n + 1, device=dev).index_add_(0, rows.clamp(max=n).long(), torch.ones(rows.shape[0], device=dev))[:n]
        empty = counts == 0
        checks.rows[-1].update({"segments": n, "empty_segments": int(empty.sum()), "valid_share": float((rows < n).float().mean()) if rows.numel() else 0.0})
        if out[empty].any():
            msg = f"segment_sum_sorted_kernel {tag}: a segment without messages is not exactly zero"
            raise AssertionError(msg)
        del want, out, grads
    sync(torch, dev)


def time_segment_calls(torch, ss, timer, rows_by_name, peak) -> list:
    """Kernel, plain-version and library times of K7 at each COO path's calls,
    with each call's bound: bytes, the valid messages (4·F) and their row ids
    (4) read once and the output written once; operations, the E_valid·F
    additions (the padding entries are neither read nor summed). The
    kernel's two launches also apart (``offsets_ms``, ``sum_ms``)."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    calls = []
    for path, name, f, per_step in SEGMENT_STEP_CALLS:
        rows, n = rows_by_name[name]
        msgs = torch.randn(rows.shape[0], f, generator=gen, device="cuda")
        ids = rows.clamp(max=n).long()
        buf = torch.zeros(n + 1, f, device="cuda")
        valid = int((rows < n).sum())
        calls.append(
            {
                "path": path,
                "kernel": "segment_sum_sorted_kernel",
                "mode": name,
                "shape": {"rows": rows.numel(), "valid_rows": valid, "segments": n},
                "F": f,
                "per_step": per_step,
                "ms": timer.ms(lambda msgs=msgs, rows=rows, n=n: ss.segment_sum_sorted_kernel(msgs, rows, n)),
                **timer.launch_ms(lambda msgs=msgs, rows=rows, n=n: ss.segment_sum_sorted_kernel(msgs, rows, n), {"offsets_ms": "row_offsets", "sum_ms": "sum_rows"}),
                "plain_ms": timer.ms(lambda msgs=msgs, rows=rows, n=n: ss.segment_sum_sorted_kernel_ref(msgs, rows, n)),
                "library_ms": timer.ms(lambda buf=buf, ids=ids, msgs=msgs: buf.index_add_(0, ids, msgs)),
                **bound((4 * f + 4) * valid, 4 * f * n, f * valid, peak),
                "bytes_all_rows": (4 * f + 4) * rows.numel() + 4 * f * n,
            }
        )
        del msgs, ids, buf
    return calls


def masked_segment_ops(torch, tseg):
    """The segment ops as they stood before the spare-row form: boolean-mask
    indexing of the in-range ids, which waits for the device (the sorted
    route to K7 is unchanged)."""
    sorted_sum = tseg.segment_sum

    def segment_sum(data, segment_ids, num_segments, indices_sorted=False):
        if indices_sorted and data.dim() == 2 and data.device.type == "cuda":
            return sorted_sum(data, segment_ids, num_segments, indices_sorted)
        keep = segment_ids < num_segments
        return data.new_zeros((num_segments, *data.shape[1:])).index_add(0, segment_ids[keep].long(), data[keep])

    def segment_max(data, segment_ids, num_segments):
        keep = segment_ids < num_segments
        rows = data[keep]
        index = segment_ids[keep].long().reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(rows)
        init = data.new_full((num_segments, *data.shape[1:]), -torch.inf)
        out = init.scatter_reduce(0, index, rows, reduce="amax", include_self=True)
        return torch.where(torch.isneginf(out), torch.zeros((), dtype=out.dtype, device=out.device), out)

    return {"segment_sum": segment_sum, "segment_max": segment_max}


def host_sync_probe(torch, card, model, batch, steps, dev) -> dict:
    """Step time of one COO path with the segment ops as they are and with
    their earlier boolean-mask form patched in, in turns (as is, masked,
    masked, as is), each over ``steps`` timed steps after one warm step."""
    import unittest.mock as mock

    from deeprank2_tpu_torch.ops import pooling as tpool
    from deeprank2_tpu_torch.ops import segment as tseg
    from deeprank2_tpu_torch.ops.losses import CrossEntropyLoss
    from deeprank2_tpu_torch.ops.optim import Adam

    loss_fn = CrossEntropyLoss()
    opt = Adam(model.parameters(), lr=1e-3, weight_decay=1e-5)
    gen = torch.Generator(device=dev).manual_seed(2)
    masked = masked_segment_ops(torch, tseg)

    def timed() -> float:
        def step():
            opt.zero_grad(set_to_none=True)
            loss_fn(model(batch, training=True, generator=gen), batch.y, batch.y_mask).backward()
            opt.step()

        step()
        sync(torch, dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        sync(torch, dev)
        return (time.perf_counter() - t0) / steps * 1e3

    times = {"as_is": [], "masked": []}
    for form in ("as_is", "masked", "masked", "as_is"):
        if form == "masked":
            with contextlib.ExitStack() as stack:
                for module in (tseg, tpool):
                    for name, fn in masked.items():
                        stack.enter_context(mock.patch.object(module, name, fn))
                times[form].append(timed())
        else:
            times[form].append(timed())
    as_is, masked_ms = statistics.mean(times["as_is"]), statistics.mean(times["masked"])
    return {"phase": "coo_host_sync", "card": card, "steps_per_turn": steps, "step_ms": times, "masked_minus_as_is_ms": masked_ms - as_is}


def full_tie_pools(torch):
    """A context in which the COO pools' segment_max gives every row that
    reaches its segment's max the full cotangent: the tie rule of the fast
    paths' member and slot pools (the COO rule shares it among the tied
    rows). Positive ties are structural in the clustered GINet (two clusters
    whose only neighbour is the same cluster get equal conv2 outputs), so the
    two rules give other gradients on the same function."""
    import unittest.mock as mock

    from deeprank2_tpu_torch.ops import pooling as tpool
    from deeprank2_tpu_torch.ops import segment as tseg

    class FullTieMax(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, ids, n):
            out = tseg.segment_max(x, ids, n)
            ctx.save_for_backward(x, out, ids)
            return out

        @staticmethod
        def backward(ctx, g):
            x, out, ids = ctx.saved_tensors
            c = ids.clamp(max=out.shape[0] - 1).long()
            winner = (x == out[c]) & (ids < out.shape[0])[:, None]
            return torch.where(winner, g[c], torch.zeros((), dtype=g.dtype, device=g.device)), None, None

    return mock.patch.object(tpool, "segment_max", FullTieMax.apply)


def logits_and_grads(torch, model, batch, context=contextlib.nullcontext) -> tuple:
    """Eval-mode logits and the gradient of their sum, by parameter name."""
    model.zero_grad(set_to_none=True)
    with context():
        logits = model(batch, training=False)
        logits.sum().backward()
    grads = {k: p.grad.detach().float() for k, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return logits.detach().float(), grads


def f64_oracle(torch, oracle, batch, context) -> tuple:
    """The COO oracle's logits and gradients computed in float64: a copy of
    the model and of the batch's float fields in f64, through the plain
    segment sum (K7 takes f32 only)."""
    import copy
    import dataclasses

    from deeprank2_tpu_torch.ops import segment as tseg

    model = copy.deepcopy(oracle).double()
    b64 = dataclasses.replace(batch, **{k: getattr(batch, k).double() for k in ("x", "pos", "edge_attr", "y")})
    tseg.set_segment_backend("xla")
    try:
        return logits_and_grads(torch, model, b64, context)
    finally:
        tseg.set_segment_backend("pallas")


def ginet_dense_gate(torch, ds, fg, route: str, flat: bool):
    """The per-entry float64 gate of GINetDense's conv weight gradients, for
    cross_check's ``tower_gate``: the fused tower's dw1 and dw2 in float64
    (tools/f64_gate.py) for the cotangent of the sum of the logits (the
    head in float64), mapped to the conv weights, first held against the COO
    oracle's float64 gradients (the same function: within their own f32
    rounding and 2^-40 of each entry's sum of |products|), then the fast
    path's gradients against them.
    On the flat route (K1, K2; ``flat``) the route's relu decisions are read
    from its own layers and its flips held to the band; the batched tower
    (K8) shows none."""

    def gate(model, batch, grads, coo_f64) -> dict:
        w1_t, w2_t = (w.detach() for w in model.fused_weights())
        w1, w2 = w1_t.T.contiguous(), w2_t.T.contiguous()
        adj, mask, x_t = batch.adj_i8, batch.node_mask, batch.x_t
        zeros = torch.zeros(w2.shape[1], adj.shape[0], device=adj.device)
        pooled = fg.tower_f64(adj, mask, x_t, w1, w2, zeros).pooled
        counts = mask.sum(dim=1).clamp_min(1)
        g_pool, g_scale = fg.dense_head_cotangent(pooled, counts, model.fc1.weight.detach(), model.fc1.bias.detach(), model.fc2.weight.detach())
        masks = None
        if flat:
            with torch.no_grad():  # the model's own layer calls
                h = ds.diag_layer_t(adj, mask, w1_t @ x_t)
                sign, _ = ds.diag_kernel(adj, w2_t @ h, mask, "relu_mask_pool")
            masks = (h > 0, sign.bool())

        def pick(t):
            return fg.ginet_dense_grads(t.dw1, t.dw2), fg.ginet_dense_grads(t.s_dw1, t.s_dw2)

        want, scale = pick(fg.tower_f64(adj, mask, x_t, w1, w2, g_pool, g_scale=g_scale))
        same = {k: (want[k] - coo_f64[k].double()).abs().max().item() for k in want}
        # coo_f64: the COO oracle's float64 gradients, as logits_and_grads
        # hands them, rounded to f32
        if any(not bool(((want[k] - coo_f64[k].double()).abs() <= 2.0**-24 * want[k].abs() + 2.0**-40 * scale[k] + 1e-12).all()) for k in want):
            msg = f"{route}: the float64 tower is not the COO oracle's float64 function: {same}"
            raise AssertionError(msg)
        row = fg.hold_tower(route, {k: grads[k] for k in want}, (adj, mask, x_t, w1, w2, g_pool), g_scale=g_scale, route_masks=masks, pick=pick)
        row["f64_tower_vs_coo_f64"] = same
        row["share_of_cross_tol_vs_coo_f64"] = {k: fg.share(grads[k], coo_f64[k], fg.ATOL) for k in want}
        return row

    return gate


def cross_check(torch, name, oracle, oracle_batch, fast, fast_batch, gate=None, oracle_context=contextlib.nullcontext, gated=lambda name: True, tower_gate=None) -> dict:
    """Logits and the gradient of the sum of the logits of a fast path, on
    the oracle's parameters in eval mode, against its COO oracle computed in
    float64 (the oracle run inside ``oracle_context``): within CROSS_TOL, or
    within ``gate`` (logits absolute; gradients relative to their largest
    magnitude, at least ``gate``); the gradients of the parameters that
    ``gated`` rejects are reported, not gated; those that ``tower_gate``
    (:func:`ginet_dense_gate`) holds, the conv weights' sums over every
    node, go to its per-entry float64 gate instead (reported against the
    COO oracle too). The f64 oracle keeps the reference's own f32
    rounding out of the comparison (one f32 sum of 100k node rows is exact
    to about 1e-5 relative); the f32 oracle's errors against it are reported
    beside the fast path's."""
    fast.load_state_dict(oracle.state_dict())
    lg, gr = logits_and_grads(torch, fast, fast_batch)
    lo, go = logits_and_grads(torch, oracle, oracle_batch, oracle_context)
    lw, gw = f64_oracle(torch, oracle, oracle_batch, oracle_context)
    if not gr.keys() == go.keys() == gw.keys():
        msg = f"{name}: gradients differ in which parameters have one: {sorted(gr)} vs {sorted(go)}"
        raise AssertionError(msg)
    errs, coo_f32_errs = {}, {}
    tower_row = None if tower_gate is None else tower_gate(fast, fast_batch, gr, gw)
    for what, got, want, f32, is_grad in [("logits", lg, lw, lo, False), *[(f"grad {k}", gr[k], gw[k], go[k], True) for k in gr]]:
        errs[what] = (got - want).abs().max().item()
        coo_f32_errs[what] = (f32 - want).abs().max().item()
        if is_grad and not gated(what.removeprefix("grad ")):
            continue
        if is_grad and tower_row is not None and what.removeprefix("grad ") in tower_row["share_of_gate"]:
            continue
        if gate is None:
            torch.testing.assert_close(got, want, **CROSS_TOL, msg=lambda m, what=what: f"{name} {what}: {m}")
        elif errs[what] > gate * (max(1.0, want.abs().max().item()) if is_grad else 1.0):
            msg = f"{name} {what}: max abs error {errs[what]} beyond the {gate} gate"
            raise AssertionError(msg)
    tolerance = CROSS_TOL if gate is None else {"gate": gate, "gradients_gated": sorted(k for k in gr if gated(k))}
    if tower_row is not None:
        tolerance = {"logits and the head's gradients": CROSS_TOL, "conv weights' gradients": f"against float64, atol max({CROSS_TOL['atol']}, c 2^-24 sum of |products|), rtol {CROSS_TOL['rtol']}"}
    scale = {k: gw[k].abs().max().item() for k in gw}
    out = {"check": name, "tolerance": tolerance, "logits_shape": list(lg.shape), "max_abs_err": errs, "coo_f32_max_abs_err": coo_f32_errs, "grad_max_abs": scale}
    if tower_row is not None:
        out["f64_gate"] = tower_row
    return out


def tower_weights(model):
    """The fused weights ``w1 [F, 32]`` and ``w2 [32, 64]`` of a GINetDense
    (the layouts of ginet_tower_pooled and tower_pooled), detached."""
    w1_t, w2_t = model.fused_weights()
    return w1_t.detach().T.contiguous(), w2_t.detach().T.contiguous()


def check_tower_kernels(torch, gt, ds, fg, checks, shapes, w1, w2, dev) -> None:
    """The fused tower kernels against their plain versions, directly and
    through their autograd Functions: K8f/K8b (ginet_tower.py) on the
    batched layout, K9f/K9b (diag_spmm.py) on the flat one. pooled and h1
    within TOL; dw1/dw2 and t1/t2 within rtol 1e-5 and DW_TOL times the sum
    of their products' absolute values (at least TOL's atol); the sign
    exactly wherever |h2| is above 1e-6 of its largest value; K9f's h1 and
    sign bit for bit against the kernel's order as a loop, K9b's t2 bit for
    bit against fl(g_pool x count); tower_pooled's weight gradients against
    float64 at the per-entry gate (``fg.hold_tower``). ``shapes``
    maps each family ("batched": K8, "flat": K9) to its batches, each
    family's largest at its own shape rule."""
    for tag, b in shapes["batched"]:
        g = b.x.shape[0]
        gen = torch.Generator(device=dev).manual_seed(len(checks.rows))
        dp = torch.randn(g, w2.shape[1], generator=gen, device=dev)
        args = (w1, w2, b.x, b.adj_i8, b.node_mask)
        scales = gt.dw_error_scale(*args, dp)
        dw_tols = [{"rtol": 1e-5, "atol": max(TOL["atol"], DW_TOL * sc.max().item())} for sc in scales]
        checks.close("ginet_tower_fwd_kernel", f"{tag} direct", gt.ginet_tower_fwd_kernel(*args), gt.ginet_tower_fwd_kernel_ref(*args), TOL)
        direct = gt.ginet_tower_bwd_kernel(*args, dp)
        outs = []
        for fn in (gt.ginet_tower_pooled, gt.ginet_tower_pooled_ref):
            a, c = w1.clone().requires_grad_(True), w2.clone().requires_grad_(True)
            out = fn(a, c, *args[2:])
            outs.append((out.detach(), *torch.autograd.grad(out, (a, c), dp)))
        checks.close("ginet_tower_fwd_kernel", f"{tag} ginet_tower_pooled fwd", outs[0][0], outs[1][0], TOL)
        for what, got_d, got_f, want, tol in zip(("dw1", "dw2"), direct, outs[0][1:], outs[1][1:], dw_tols):
            checks.close("ginet_tower_bwd_kernel", f"{tag} direct {what}", got_d, want, tol)
            checks.close("ginet_tower_bwd_kernel", f"{tag} ginet_tower_pooled vjp {what}", got_f, want, tol)
            checks.rows[-1]["atol"] = tol["atol"]
        del direct, outs
    for tag, b in shapes["flat"]:
        gen = torch.Generator(device=dev).manual_seed(len(checks.rows))
        dp = torch.randn(b.x.shape[0], w2.shape[1], generator=gen, device=dev)
        fargs = (b.adj_i8, b.x_t, b.node_mask, w1, w2)
        h1, sign, pooled = ds.tower_fwd_kernel(*fargs)
        h1_r, sign_r, pooled_r = ds.tower_fwd_kernel_ref(*fargs)
        checks.close("tower_fwd_kernel", f"{tag} direct h1", h1, h1_r, TOL)
        checks.close("tower_fwd_kernel", f"{tag} direct pooled", pooled, pooled_r, TOL)
        # h1 and the sign of h2 in the kernel's order: bit for bit
        h1_o, sign_o = ds.tower_fwd_order_ref(*fargs)
        checks.close("tower_fwd_kernel", f"{tag} h1 vs the order loop", h1, h1_o, EXACT)
        checks.close("tower_fwd_kernel", f"{tag} sign vs the order loop", sign, sign_o, EXACT)
        del h1_o, sign_o
        h2 = ds.diag_kernel_ref(b.adj_i8, w2.T @ h1_r, b.node_mask, "relu_mask")
        flips = ((sign != sign_r) & (h2.abs() > 1e-6 * h2.abs().max())).sum().item()
        checks.rows.append({"kernel": "tower_fwd_kernel", "check": f"{tag} sign", "sign_flips_clear_of_zero": flips})
        if flips:
            msg = f"tower_fwd_kernel {tag}: the sign differs from the plain version at {flips} values clear of zero"
            raise AssertionError(msg)
        bwd = (b.adj_i8, dp.T.contiguous(), sign_r, h1_r, w2)
        t2_t1 = ds.tower_bwd_kernel(*bwd)
        for what, got, want, scale in zip(("t2", "t1"), t2_t1, ds.tower_bwd_kernel_ref(*bwd), ds.tower_bwd_error_scale(*bwd)):
            tol = {"rtol": 1e-5, "atol": max(TOL["atol"], DW_TOL * scale.max().item())}
            checks.close("tower_bwd_kernel", f"{tag} direct {what}", got, want, tol)
            checks.rows[-1]["atol"] = tol["atol"]
        # t2 = fl(g_pool x the count of neighbours whose sign is set): exact
        n = b.adj_i8.shape[1]
        counts = ds.diag_kernel_ref(b.adj_i8, sign_r.float())
        checks.close("tower_bwd_kernel", f"{tag} t2 vs fl(g_pool x count)", t2_t1[0], bwd[1].repeat_interleave(n, dim=1) * counts + 0.0, EXACT)
        del t2_t1, counts
        g_pool = bwd[1]
        outs = []
        for fn in (ds.tower_pooled, ds.tower_pooled_ref):
            a, c = w1.clone().requires_grad_(True), w2.clone().requires_grad_(True)
            out = fn(b.adj_i8, b.node_mask, b.x_t, a, c)
            outs.append((out.detach(), *torch.autograd.grad(out, (a, c), g_pool)))
        checks.close("tower_fwd_kernel", f"{tag} tower_pooled fwd", outs[0][0], outs[1][0], TOL)
        # the weight gradients of tower_pooled and tower_pooled_ref against
        # float64 at the per-entry gate; against each other reported with
        # their share of the fixed gate
        args = (b.adj_i8, b.node_mask, b.x_t, w1, w2, g_pool)
        rows = [
            fg.hold_tower(f"{tag} {name}", dict(zip(("pooled", "dw1", "dw2"), out)), args, route_masks=masks)
            for name, out, masks in (("tower_pooled", outs[0], (h1 > 0, sign.bool())), ("tower_pooled_ref", outs[1], (h1_r > 0, sign_r.bool())))
        ]
        between = {what: {"max_abs_err": (x - y).abs().max().item(), "share_of_fixed_gate": fg.share(x, y, fg.ATOL)} for what, x, y in zip(("dw1", "dw2"), outs[0][1:], outs[1][1:])}
        checks.rows.append({"kernel": "tower_bwd_kernel", "check": f"{tag} tower_pooled vjp dw1, dw2 vs float64", "gate": rows, "vs_tower_pooled_ref": between})
        del outs, h1, sign, pooled, h1_r, sign_r, pooled_r, h2
    sync(torch, dev)


def time_tower_calls(torch, gt, ds, timer, b, w1, w2, peak, compute_dtype=None) -> list:
    """Kernel and plain-version times of K8f, K8b, K9f and K9b at the bench
    batch, beside the flat route that computes the same function on the same
    card (forward: K1 relu F=32 and K1 pool F=64; backward: K2 F=64 and K1
    plain F=32), and each call's bound: bytes, every input read once and
    every output written once; operations, the weight products (dense) and
    the aggregates over this adjacency's nonzeros (2 per entry and
    channel), the weight products of the bf16 form (bf16 operands, f32
    sums) at the bf16 tensor-core rate. No single PyTorch call computes any
    of them. The bf16 form (``compute_dtype``) reads the same f32 x and
    weights (K9b writes t2/t1 at 2 bytes), and is timed beside its f32 form
    (``f32_form_ms``) and the flat route's bf16 K1/K2. Each call's device
    time from the profiler too (``device_ms``), and K8b's two launches apart
    (``partials_ms``, ``sum_ms``)."""
    cd = compute_dtype
    act = ds.activation_dtype(cd)
    tb = torch.tensor([], dtype=act).element_size()
    g, n, f = b.x.shape
    c1, c2 = w1.shape[1], w2.shape[1]
    gn = g * n
    nnz = int(b.adj_i8.count_nonzero().item())
    gen = torch.Generator(device="cuda").manual_seed(16)
    dp = torch.randn(g, c2, generator=gen, device="cuda")
    g_pool = dp.T.contiguous()
    args = (w1, w2, b.x, b.adj_i8, b.node_mask)
    fargs = (b.adj_i8, b.x_t, b.node_mask, w1, w2)
    h1, sign, _ = ds.tower_fwd_kernel_ref(*fargs, cd)
    # the flat route's kernels on the same batch and weights
    fcx1, fcx2 = (w1.T @ b.x_t).to(act), (w2.T @ h1).to(act)
    flat_sign, _ = ds.diag_kernel(b.adj_i8, fcx2, b.node_mask, "relu_mask_pool", cd)
    u1 = torch.randn(c1, gn, generator=gen, device="cuda").to(act)
    g_pool_act = g_pool.to(act)
    flat_fwd = timer.ms(lambda: ds.diag_kernel(b.adj_i8, fcx1, b.node_mask, "relu_mask", cd)) + timer.ms(lambda: ds.diag_kernel(b.adj_i8, fcx2, b.node_mask, "relu_mask_pool", cd))
    flat_bwd = timer.ms(lambda: ds.pool_bwd_kernel(b.adj_i8, flat_sign, g_pool_act, cd)) + timer.ms(lambda: ds.diag_kernel(b.adj_i8, u1, compute_dtype=cd))
    weights = 4 * (f * c1 + c1 * c2)
    w_ops = 2 * gn * (f * c1 + c1 * c2)
    agg_ops = 2 * nnz * (c1 + c2)
    dense_agg = 2 * g * n * n * (c1 + c2)
    adj_bytes = b.adj_i8.numel()
    x_bytes = 4 * gn * f
    # (kernel, path, run, plain version, bytes in, bytes out, weight-product
    # operations, aggregate operations, aggregates counted dense, flat route)
    specs = (
        ("ginet_tower_fwd_kernel", "dense_tower", lambda c=cd: gt.ginet_tower_fwd_kernel(*args, c), lambda: gt.ginet_tower_fwd_kernel_ref(*args, cd),
         adj_bytes + x_bytes + gn + weights, 4 * g * c2, w_ops, agg_ops, dense_agg, flat_fwd),
        ("ginet_tower_bwd_kernel", "dense_tower", lambda c=cd: gt.ginet_tower_bwd_kernel(*args, dp, c), lambda: gt.ginet_tower_bwd_kernel_ref(*args, dp, cd),
         adj_bytes + x_bytes + gn + weights + 4 * g * c2, weights, 2 * w_ops + 2 * gn * c1 * c2, 2 * agg_ops, 2 * dense_agg, flat_bwd),
        ("tower_fwd_kernel", "dense_fused_tower", lambda c=cd: ds.tower_fwd_kernel(*fargs, c), lambda: ds.tower_fwd_kernel_ref(*fargs, cd),
         adj_bytes + x_bytes + gn + weights, 4 * c1 * gn + c2 * gn + 4 * c2 * g, w_ops, agg_ops, dense_agg, flat_fwd),
        ("tower_bwd_kernel", "dense_fused_tower", lambda c=cd: ds.tower_bwd_kernel(b.adj_i8, g_pool, sign, h1, w2, c), lambda: ds.tower_bwd_kernel_ref(b.adj_i8, g_pool, sign, h1, w2, cd),
         adj_bytes + 4 * c2 * g + c2 * gn + 4 * c1 * gn + 4 * c1 * c2, tb * (c1 + c2) * gn, 2 * gn * c1 * c2, agg_ops, dense_agg, flat_bwd),
    )  # fmt: skip
    suffix = "" if cd is None else "_bf16"
    return [
        {
            "path": path + suffix,
            "kernel": kernel,
            "mode": "fused tower",
            "form": ds.form_name(torch.int8, act),
            "shape": [g, n, n],
            "F": f,
            "ms": timer.ms(run),
            **timer.launch_ms(run, {"device_ms": "", **({"partials_ms": "ginet_tower_bwd_graph", "sum_ms": "sum_partials"} if kernel == "ginet_tower_bwd_kernel" else {})}),
            **({} if cd is None else {"f32_form_ms": timer.ms(lambda run=run: run(None))}),
            "plain_ms": timer.ms(plain),
            "library_ms": None,
            "flat_route_ms": flat,
            **bound(in_bytes, out_bytes, w + agg, peak, 0 if cd is None else w),
            "adjacency_nnz": nnz,
            "flop_needed": w + agg,
            "flop_dense": w + dense,
        }
        for kernel, path, run, plain, in_bytes, out_bytes, w, agg, dense, flat in specs
    ]


def fused_tower_drive(torch, ds, fg, do, counters, b, w1, w2, steps, dev, compute_dtype=None) -> dict:
    """tower_pooled on the bench batch: the fused tower, the flat route
    (diag_layer_t then diag_layer_pool_t, the same function) and
    tower_pooled_ref each against the function in float64 (``fg.hold_tower``:
    pooled sums within CROSS_TOL, weight gradients at the per-entry gate,
    each route's relu flips held to their band), the routes against each
    other reported (``do`` reads the flat route's relu decisions); then, with
    the counters at 0, ``steps`` forward/backward passes and one forward:
    K9f steps + 1, K9b steps, every other kernel 0, all of the form
    ``compute_dtype`` selects. The bf16 form is held instead against the
    same pass on the CPU (the kernels' plain versions of that form) and
    against tower_pooled_ref in bf16 (the plain ops, written apart, on the
    card) at BF16_STEP_TOL: each rounds values that they sum in other
    orders."""
    cd = compute_dtype
    gen = torch.Generator(device=dev).manual_seed(17)
    g_pool = torch.randn(w2.shape[1], b.x.shape[0], generator=gen, device=dev)

    def flat(adj, mask, x_t, a, c):
        return ds.diag_layer_pool_t(adj, mask, c.T @ ds.diag_layer_t(adj, mask, a.T @ x_t))

    def fused(adj, mask, x_t, a, c):
        return ds.tower_pooled(adj, mask, x_t, a, c, cd)

    def pass_(fn, b=b, w1=w1, w2=w2, g_pool=g_pool):
        a, c = w1.clone().requires_grad_(True), w2.clone().requires_grad_(True)
        out = fn(b.adj_i8, b.node_mask, b.x_t, a, c)
        return (out.detach(), *torch.autograd.grad(out, (a, c), g_pool))

    got = pass_(fused)
    errs, gates = {}, None
    if cd is None:
        # each route against float64: pooled at CROSS_TOL, dw1 and dw2 at the
        # per-entry gate; the routes against each other reported
        args = (b.adj_i8, b.node_mask, b.x_t, w1, w2, g_pool)
        h1, sign, _ = ds.tower_fwd_kernel(b.adj_i8, b.x_t, b.node_mask, w1, w2)
        h1_r, sign_r, _ = ds.tower_fwd_kernel_ref(b.adj_i8, b.x_t, b.node_mask, w1, w2)
        routes = {
            "fused tower": (got, (h1 > 0, sign.bool())),
            "flat route": (pass_(flat), do.flat_masks(b.adj_i8, b.node_mask, b.x_t, w1, w2)),
            "tower_pooled_ref": (pass_(ds.tower_pooled_ref), (h1_r > 0, sign_r.bool())),
        }
        del h1, sign, h1_r, sign_r
        gates = [fg.hold_tower(name, dict(zip(("pooled", "dw1", "dw2"), outs)), args, route_masks=masks) for name, (outs, masks) in routes.items()]
        for oracle in ("tower_pooled_ref", "flat route"):
            for what, x, y in zip(("pooled", "dw1", "dw2"), got, routes[oracle][0]):
                errs[f"{what} vs {oracle}"] = {"max_abs_err": (x - y).abs().max().item(), "share_of_cross_tol": fg.share(x, y, CROSS_TOL["atol"])}
        tol = {"pooled": CROSS_TOL, "dw1, dw2": f"each route against float64: atol max({fg.ATOL}, {fg.C} * 2^-24 * sum of |products|), rtol {fg.RTOL}"}
        del routes
    else:
        cpu = pass_(fused, b.to("cpu"), w1.cpu(), w2.cpu(), g_pool.cpu())
        ref = pass_(lambda *a: ds.tower_pooled_ref(*a, compute_dtype=cd))
        tol = BF16_STEP_TOL
        for oracle, want in (("the CPU", [t.to(dev) for t in cpu]), ("tower_pooled_ref", ref)):
            for what, x, y in zip(("pooled", "dw1", "dw2"), got, want):
                t = {"rtol": tol["rtol"], "atol": tol["atol_share"] * y.abs().max().item()}
                torch.testing.assert_close(x, y, **t, msg=lambda m, what=what, oracle=oracle: f"tower_pooled {what} vs {oracle}: {m}")
                errs[f"{what} vs {oracle}"] = (x - y).abs().max().item()
    sync(torch, dev)
    counters.reset()
    t0 = time.perf_counter()
    for _ in range(steps):
        pass_(fused)
    sync(torch, dev)
    pass_s = (time.perf_counter() - t0) / steps
    with torch.no_grad():
        last = fused(b.adj_i8, b.node_mask, b.x_t, w1, w2)
    sync(torch, dev)
    launches, forms = counters.read(), counters.read_forms()
    want = want_launches(tower_fwd_kernel=steps + 1, tower_bwd_kernel=steps)
    form = ds.form_name(torch.int8, ds.activation_dtype(cd))
    want_forms = {f"tower_fwd_kernel[{form}]": steps + 1, f"tower_bwd_kernel[{form}]": steps}
    if launches != want or forms != want_forms:
        msg = f"dense_fused_tower launches {launches} by form {forms}, expected {want} by form {want_forms}"
        raise AssertionError(msg)
    if not torch.isfinite(last).all() or tuple(last.shape) != (w2.shape[1], b.x.shape[0]):
        msg = f"non-finite or misshapen pooled sums {tuple(last.shape)}"
        raise AssertionError(msg)
    return {
        "tolerance": tol,
        **({} if gates is None else {"gate_rows": gates}),
        "max_abs_err": errs,
        "passes": steps,
        "pass_ms": pass_s * 1e3,
        "launches": launches,
        "launches_expected": want,
        "launches_by_form": forms,
    }


def kernels_line(calls, path_launches, errs, path_forms, form_errs, form_calls=()) -> list:
    """One entry per kernel: times and bounds summed over the kernel's calls in
    one train step of each path it runs on (also given by path); launches
    summed over the counted runs of every path (also given by path). K1, K2,
    K5, K6f and K6b also by form (``forms``: the adjacency or block type,
    int8 0/1 or the bf16 and f32 weights of sGAT, then the activation type,
    f32 or the single-pass bf16 form; K6 by activation type), each with its
    launches, its largest error and every timed call of that form (the
    paths' calls and ``form_calls``, timed on no path's step), per launch."""

    def total(rows, key):
        values = [c[key] for c in rows]
        return None if not rows or any(x is None for x in values) else sum(c[key] * c.get("per_step", 1) for c in rows)

    def times(rows):
        return {k: total(rows, k) for k in ("ms", "plain_ms", "bound_ms", "library_ms")}

    kernels = []
    for name in KERNELS:
        mine = [c for c in calls if c["kernel"] == name]
        by_path, by_form = {}, {}
        for c in mine:
            by_path.setdefault(c["path"].removesuffix("_pooled").removesuffix("_slot"), []).append(c)
        for c in [*mine, *(c for c in form_calls if c["kernel"] == name)]:
            if "form" in c:
                by_form.setdefault(c["form"], []).append(c)
        forms = {form for (kernel, form) in form_errs if kernel == name} | set(by_form)
        forms |= {key.split("[")[1].rstrip("]") for launches in path_forms.values() for key in launches if key.startswith(f"{name}[")}
        kernels.append(
            {
                "name": name,
                "route": "cuda",
                "source": SOURCES[name],
                "replaces": REPLACES[name],
                "launches": sum(launches[name] for launches in path_launches.values()),
                "launches_by_path": {path: launches[name] for path, launches in path_launches.items()},
                "max_abs_err": errs[name],
                "per": "one train step of each path: " + ", ".join(f"{c['path']} {c['mode']} F={c['F']} x{c.get('per_step', 1)}" for c in mine),
                "ms": total(mine, "ms"),
                **({"device_ms": total(mine, "device_ms")} if mine and all("device_ms" in c for c in mine) else {}),
                "plain_ms": total(mine, "plain_ms"),
                "bound_ms": total(mine, "bound_ms"),
                "bound_by": "bytes" if all(c["bound_by"] == "bytes" for c in mine) else "operations",
                "library_ms": total(mine, "library_ms"),
                "library": LIBRARY[name],
                **({"flat_route_ms": total(mine, "flat_route_ms")} if mine and all("flat_route_ms" in c for c in mine) else {}),
                **({"bodies": sorted({c["body"] for c in mine})} if mine and all("body" in c for c in mine) else {}),
                "by_path": {path: times(rows) for path, rows in by_path.items()},
                **(
                    {
                        "forms": {
                            form: {
                                "launches": sum(launches.get(f"{name}[{form}]", 0) for launches in path_forms.values()),
                                "max_abs_err": form_errs.get((name, form)),
                                "calls": [
                                    {k: c[k] for k in ("path", "mode", "F", "per_step", "body", "ms", "device_ms", "offsets_ms", "partials_ms", "sum_ms", "f32_form_ms", "plain_ms", "flat_route_ms", "bound_ms", "bound_by", "library_ms", "library_device_ms", "library_form") if k in c}
                                    for c in by_form.get(form, [])
                                ],
                            }
                            for form in sorted(forms)
                        }
                    }
                    if forms
                    else {}
                ),
            }
        )
    return kernels


def clustered_path(torch, ds, fg, counters, card, entries, layout_check, steps, dev, phase) -> dict:
    """Collate, check against the CPU, and drive one clustered layout."""
    from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetClusteredDiag
    from deeprank2_tpu_torch.ops.batch import collate_graphs_diag_clustered
    from deeprank2_tpu_torch.ops.losses import CrossEntropyLoss
    from deeprank2_tpu_torch.ops.optim import Adam

    t0 = time.perf_counter()
    batch, _ = collate_graphs_diag_clustered(entries, device=dev)
    collate_s = time.perf_counter() - t0
    layout_check(batch)
    feat = CLUSTERED["feat"]
    model = GINetClusteredDiag(feat, 2, 1, device=dev, generator=torch.Generator().manual_seed(0))
    loss_fn = CrossEntropyLoss()
    step, cpu_model, cpu_batch = card_vs_cpu_step(
        torch, model, batch, loss_fn, lambda: GINetClusteredDiag(feat, 2, 1, device="cpu"), CLUSTERED_TOL, CLUSTERED_GRAD_TOL
    )
    flips = slot_winner_flips(torch, ds, fg, model, batch, cpu_model, cpu_batch)
    emit({"phase": f"{phase}_card_vs_cpu_step", "tolerance": CLUSTERED_TOL, "grad_tolerance": CLUSTERED_GRAD_TOL, **step, "max_pool": flips})
    opt = Adam(model.parameters(), lr=1e-3, weight_decay=1e-5)
    regions = sum(1 for ns in (batch.region_caps or (1,))[:3] if ns)
    want = want_launches(diag_kernel=4 * steps + 2, slot_fwd_kernel=regions * (steps + 1), slot_bwd_kernel=regions * steps)
    run = run_main_path(torch, counters, model, batch, loss_fn, opt, dev, want, steps, warm=min(WARM_STEPS, steps // 3))
    real_edges = int(sum(2 * e["edge_index"].shape[0] for e in entries))
    train_step = run.pop("train_step")
    emit(
        {
            "phase": phase,
            "card": card,
            "model": "GINetClusteredDiag(38, 2, 1)",
            "batch": {**CLUSTERED, "region_caps": list(batch.region_caps), "adj": list(batch.adj_i8.shape), "adj_p": list(batch.adj_p_i8.shape)},
            "collate_s": collate_s,
            **run,
            "step_ms": run["step_s"] * 1e3,
            "edges_per_s": real_edges / run["step_s"],
            "real_edges": real_edges,
        }
    )
    return {"batch": batch, "launches": run["launches"], "launches_by_form": run["launches_by_form"], "train_step": train_step, "step_s": run["step_s"]}


def bcsr_winner_flips(torch, bs, model, batch, cpu_model, cpu_batch) -> dict:
    """Slot groups of the layer-1 activation whose max-pool winner (first
    max lane) differs between card and CPU: ties to summation-order error
    (and, in the bf16 form, to the bf16 rounding it moves)."""
    hs = []
    with torch.no_grad():
        for m, b in ((model, batch), (cpu_model, cpu_batch)):
            w1_t, _ = m.fused_weights()
            hs.append(torch.relu(bs.bcsr_spmm_t(b.structure, w1_t @ b.x.T, m.compute_dtype)).cpu())
    f, v = hs[0].shape
    win = [h.reshape(f, v // 8, 8).argmax(dim=2) for h in hs]
    live = hs[1].reshape(f, v // 8, 8).amax(dim=2) > 0
    return {"groups_with_a_positive_max": int(live.sum()), "winner_flips": {"slot8": int(((win[0] != win[1]) & live).sum())}}


def checked_path(
    torch,
    counters,
    card,
    batch,
    model_factory,
    want,
    dev,
    phase,
    describe,
    flips=None,
    steps=BCSR_STEPS,
    want_forms=None,
    check_batch=None,
    grad_tol=CLUSTERED_GRAD_TOL,
    tol=CLUSTERED_TOL,
) -> dict:
    """Check one path (BCSR, blocked-edge, COO or Diag) against the CPU,
    drive it with the counters at 0, and profile a few of its steps. The
    check runs on ``check_batch`` where one is given (a smaller batch of the
    same layout, when the plain versions at full size cost too much on the
    CPU), else on ``batch``."""
    from deeprank2_tpu_torch.ops.losses import CrossEntropyLoss
    from deeprank2_tpu_torch.ops.optim import Adam

    model = model_factory(dev)
    loss_fn = CrossEntropyLoss()
    checked = batch if check_batch is None else check_batch
    step, cpu_model, cpu_batch = card_vs_cpu_step(torch, model, checked, loss_fn, lambda: model_factory("cpu"), tol, grad_tol)
    info = {"phase": f"{phase}_card_vs_cpu_step", "tolerance": tol, "grad_tolerance": grad_tol, **step}
    if check_batch is not None:
        info["checked_on"] = describe.get("check_batch", "a smaller batch")
    if flips is not None:
        info["max_pool"] = flips(model, checked, cpu_model, cpu_batch)
    del cpu_model, cpu_batch
    # a cross-entropy that saturates on one confident graph has vanishing
    # gradients; the sum of the logits holds the whole backward all the same
    probe, _, _ = card_vs_cpu_step(torch, model, checked, lambda logits, y, y_mask: logits.sum(), lambda: model_factory("cpu"), tol, grad_tol)
    emit({**info, "sum_of_logits_probe": probe})
    opt = Adam(model.parameters(), lr=1e-3, weight_decay=1e-5)
    run = run_main_path(torch, counters, model, batch, loss_fn, opt, dev, want, steps, want_forms=want_forms)
    train_step = run.pop("train_step")
    real_edges = 2 * describe.pop("undirected_edges")
    emit({"phase": phase, "card": card, **describe, **run, "step_ms": run["step_s"] * 1e3, "edges_per_s": real_edges / run["step_s"], "real_edges": real_edges})
    emit({"phase": f"profile_{phase.removeprefix('main_path_')}", "card": card, **profile_steps(torch, train_step, run["step_s"])})
    return run


def weighted_adjacency(torch, g, n, dtype, dev, seed):
    """A symmetric weighted adjacency (|N(0, 1)| + 0.1, summed over both
    directions) on 16 neighbours a node, with a masked, edgeless tail, stored
    as ``dtype``, and its node mask."""
    gen = torch.Generator().manual_seed(seed)
    edges = torch.rand(g, n, n, generator=gen) < 16 / n
    edges = edges | edges.transpose(1, 2)
    mask = torch.ones(g, n, dtype=torch.bool)
    mask[:, n - n // 5 :] = False
    edges &= mask[:, :, None] & mask[:, None, :]
    w = torch.randn(g, n, n, generator=gen).abs() + 0.1
    return ((w + w.transpose(1, 2)) * edges).to(dtype).to(dev), mask.to(dev)


def expected_check_launches(ds, bs, diag_shapes, bcsr_shapes, compute_dtype=None, blocked_shapes=()) -> dict:
    """The launches by form that check_diag_kernels, check_bcsr_kernel and
    check_blocked_kernels make through the wrappers: per feature width, K1
    six times (three modes directly, two layer forwards, one layer VJP) and
    K2 twice; K5 three times (directly, and bcsr_spmm_t's forward and VJP);
    K6f and K6b twice each (directly, and through blocked_message_sum)."""
    act = ds.activation_dtype(compute_dtype)
    want = {}

    def add(key, n):
        want[key] = want.get(key, 0) + n

    for _, adj, _, feats in diag_shapes:
        form = ds.form_name(adj.dtype, act)
        add(f"diag_kernel[{form}]", 6 * len(feats))
        add(f"pool_bwd_kernel[{form}]", 2 * len(feats))
    for _, st, feats in bcsr_shapes:
        add(f"bcsr_spmm_kernel[{bs.form_name(st.blocks_t.dtype, act)}]", 3 * len(feats))
    for _, _, ms in blocked_shapes:
        for kernel in ("blocked_fwd_kernel", "blocked_bwd_kernel"):
            add(f"{kernel}[{ds.dtype_name(act)}]", 2 * len(ms))
    return want


def sgat_foutnet_phases(torch, dev, card, counters, checks, peak, record, c_entries, c_batch, c_entry, cb_batch, cc_batch) -> list:
    """Phases 20-26: the weighted forms of K5 and K1 against their plain
    versions and their times, then the four FoutNet and sGAT paths (each
    checked one step against the CPU, driven with the counters at 0 and
    profiled), then their cross-checks against the COO oracle. ``c_batch``
    and ``cb_batch`` are the unweighted Diag and BCSR batches of the
    clustered cells, ``cc_batch`` the COO batch of ``c_entries``. Returns
    the timed calls of the paths and those of the f32 storage (on no path's
    step)."""
    import dataclasses
    import types

    from deeprank2_tpu_torch.neuralnets.gnn.clustered_blocksparse import FoutNetBlockSparse, SGATBlockSparse
    from deeprank2_tpu_torch.neuralnets.gnn.foutnet import FoutNet, FoutNetDiag
    from deeprank2_tpu_torch.neuralnets.gnn.sgat import SGAT, SGATDiag
    from deeprank2_tpu_torch.ops import block_sparse as bs
    from deeprank2_tpu_torch.ops import diag_spmm as ds
    from deeprank2_tpu_torch.ops import slotpool as sp
    from deeprank2_tpu_torch.ops.batch import collate_graphs, collate_graphs_blocksparse_clustered, collate_graphs_diag_clustered
    from deeprank2_tpu_torch.ops.synthetic import clustered_entry, ppi_clustered_entries
    from deeprank2_tpu_torch.tools.timing import Timer

    # 20. the weighted kernel forms against their plain versions
    t0 = time.perf_counter()
    sd_batch, _ = collate_graphs_diag_clustered(c_entries, with_edge_weights=True, device=dev)
    sgat_diag_collate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sw_batch, _ = collate_graphs_blocksparse_clustered([c_entry], with_edge_weights=True, slot8=True, device=dev)
    sgat_bcsr_collate_s = time.perf_counter() - t0
    ragged_w, _ = collate_graphs_blocksparse_clustered(
        [clustered_entry(700, 38, 1, seed=1), clustered_entry(1300, 38, 1, seed=2)], pad_graphs=3, with_edge_weights=True, device=dev
    )
    small_w, _ = collate_graphs_diag_clustered(ppi_clustered_entries(7, 96, 38, seed=5), with_edge_weights=True, min_slot_nodes=1, device=dev)
    adj336, mask336 = weighted_adjacency(torch, 4, 336, torch.bfloat16, dev, seed=336)
    pooled_f32 = dataclasses.replace(sw_batch.structure_p, blocks_t=sw_batch.structure_p.blocks_t.float())
    n, k = sd_batch.adj_w.shape[1], sd_batch.adj_wp.shape[1]
    diag_shapes = [
        (f"sgat_diag adj_w bf16 G=512 N={n}", sd_batch.adj_w, sd_batch.node_mask, (16,)),
        (f"sgat_diag adj_wp bf16 G=512 K={k}", sd_batch.adj_wp, sd_batch.pooled_mask, (32,)),
        (f"sgat_diag adj_wp as f32 G=512 K={k}", sd_batch.adj_wp.float(), sd_batch.pooled_mask, (32,)),
        (f"weighted ragged bf16 G=7 N={small_w.adj_w.shape[1]}", small_w.adj_w, small_w.node_mask, (38,)),
        ("synthetic weighted bf16 G=4 N=336", adj336, mask336, (16,)),
    ]
    bcsr_shapes = [
        (f"sgat_bcsr full bf16 {sw_batch.structure.num_chunks} chunks", sw_batch.structure, (16,)),
        ("sgat_bcsr pooled bf16", sw_batch.structure_p, (32,)),
        ("sgat_bcsr pooled as f32", pooled_f32, (32,)),
        ("weighted ragged bf16 700+1300+empty graph", ragged_w.structure, (19,)),
    ]
    n_checks = len(checks.rows)
    counters.reset()
    check_diag_kernels(torch, ds, checks, diag_shapes, dev)
    check_bcsr_kernel(torch, bs, checks, bcsr_shapes, dev)
    forms, want = counters.read_forms(), expected_check_launches(ds, bs, diag_shapes, bcsr_shapes)
    if forms != want:
        msg = f"the weighted checks launched {forms}, expected {want}"
        raise AssertionError(msg)
    tolerance = {"K1, K2": TOL, "K5 weighted": {"rtol": 1e-5, "atol": f"max(1e-5, {DW_TOL} * max |A| |x|)"}}
    emit({"phase": "weighted_kernels_vs_plain", "tolerance": tolerance, "launches_by_form": forms, "checks": checks.rows[n_checks:]})
    del ragged_w, small_w, adj336, mask336

    # 21. their times, and those of the FoutNet paths' unweighted calls
    timer = Timer()
    bcsr_specs = [("structure", 16, 2), ("structure_p", 32, 2)]
    calls = time_bcsr_calls(torch, bs, timer, "sgat_bcsr", sw_batch, bcsr_specs, peak)
    calls += time_bcsr_calls(torch, bs, timer, "foutnet_bcsr", cb_batch, bcsr_specs, peak)
    for path, batch, full, pooled in (("sgat_diag", sd_batch, sd_batch.adj_w, sd_batch.adj_wp), ("foutnet_diag", c_batch, c_batch.adj_i8, c_batch.adj_p_i8)):
        calls += time_diag_calls(torch, ds, timer, path, full, batch.node_mask, [("diag_kernel", "plain", 16, 2)], peak)
        calls += time_diag_calls(torch, ds, timer, f"{path}_pooled", pooled, batch.pooled_mask, [("diag_kernel", "plain", 32, 2)], peak)
    slot_specs = [("slot_fwd_kernel", 8, 16), ("slot_bwd_kernel", 8, 16)]
    for path, batch in (("sgat_diag", sd_batch), ("foutnet_diag", c_batch), ("sgat_bcsr", sw_batch), ("foutnet_bcsr", cb_batch)):
        calls += time_slot_calls(torch, sp, timer, f"{path}_slot", batch.node_mask.float().reshape(1, -1), slot_specs, peak)
    # the f32 storage (the collates' exact-oracle mode), timed on no path's step
    f32_calls = time_bcsr_calls(torch, bs, timer, "f32_storage", types.SimpleNamespace(structure_p=pooled_f32), [("structure_p", 32, 0)], peak)
    f32_calls += time_diag_calls(torch, ds, timer, "f32_storage", sd_batch.adj_wp.float(), sd_batch.pooled_mask, [("diag_kernel", "plain", 32, 0)], peak)
    del timer, pooled_f32
    emit({"phase": "weighted_kernel_times", "card": card, "l2_flushed": True, "calls": calls, "f32_storage_calls": f32_calls})

    # 22-25. the four paths, each checked against the CPU, counted and profiled
    steps = SGAT_FOUTNET_STEPS
    per_path = want_launches(slot_fwd_kernel=steps + 1, slot_bwd_kernel=steps)
    diag_undirected = int(sum(e["edge_index"].shape[0] for e in c_entries))
    for name, cls, batch, collate_s in (("sgat_diag", SGATDiag, sd_batch, sgat_diag_collate_s), ("foutnet_diag", FoutNetDiag, c_batch, None)):
        form = ds.form_name(batch.adj_w.dtype if name == "sgat_diag" else batch.adj_i8.dtype, torch.float32)
        record(name, checked_path(
            torch,
            counters,
            card,
            batch,
            lambda d, cls=cls: cls(CLUSTERED["feat"], 2, 1, device=d, generator=torch.Generator().manual_seed(0)),
            {**per_path, "diag_kernel": 4 * steps + 2},
            dev,
            f"main_path_{name}",
            {
                "model": f"{cls.__name__}(38, 2, 1)",
                "batch": {**CLUSTERED, "weighted": name == "sgat_diag", "form": form, "adj": list(batch.adj_i8.shape), "adj_p": list(batch.adj_p_i8.shape)},
                "collate_s": collate_s,
                "undirected_edges": diag_undirected,
            },
            steps=steps,
            want_forms={f"diag_kernel[{form}]": 4 * steps + 2},
            grad_tol=SGAT_FOUTNET_GRAD_TOL,
        ))
    # the CPU side of the 100k-node steps checks a 20k-node graph of the same
    # generator (the plain versions at full size would double the script's time)
    small = clustered_entry(SGAT_FOUTNET_CHECK_NODES, 38, 1, seed=CLUSTERED_BCSR["seed"])
    for name, cls, batch, collate_s in (("sgat_bcsr", SGATBlockSparse, sw_batch, sgat_bcsr_collate_s), ("foutnet_bcsr", FoutNetBlockSparse, cb_batch, None)):
        weighted = name == "sgat_bcsr"
        form = bs.form_name(batch.structure.blocks_t.dtype, torch.float32)
        check_batch, _ = collate_graphs_blocksparse_clustered([small], with_edge_weights=weighted, slot8=True, device=dev)
        record(name, checked_path(
            torch,
            counters,
            card,
            batch,
            lambda d, cls=cls: cls(CLUSTERED_BCSR["feat"], 2, 1, device=d, generator=torch.Generator().manual_seed(0)),
            {**per_path, "bcsr_spmm_kernel": 4 * steps + 2},
            dev,
            f"main_path_{name}",
            {
                "model": f"{cls.__name__}(38, 2, 1)",
                "batch": {**CLUSTERED_BCSR, "weighted": weighted, "form": form, "blocks_nonzero": batch.structure.tile_blocks.numel()},
                "collate_s": collate_s,
                "undirected_edges": int(c_entry["edge_index"].shape[0]),
                "check_batch": f"clustered_entry({SGAT_FOUTNET_CHECK_NODES}, 38, 1), slot8",
            },
            steps=steps,
            want_forms={f"bcsr_spmm_kernel[{form}]": 4 * steps + 2},
            check_batch=check_batch,
            grad_tol=SGAT_FOUTNET_GRAD_TOL,
        ))
        del check_batch

    # 26. against the COO oracle in float64, with f32 weight storage; the
    # conv gradients pass through the max pools (both tie rules reported)
    sd32, _ = collate_graphs_diag_clustered(c_entries, with_edge_weights=True, weight_dtype=torch.float32, device=dev)
    sw32, _ = collate_graphs_blocksparse_clustered([c_entry], with_edge_weights=True, weight_dtype=torch.float32, slot8=True, device=dev)
    atomic_c, _ = collate_graphs([c_entry], device=dev)
    head_only = lambda name: not name.startswith("conv")  # noqa: E731
    cross = []
    for oracle_cls, fast_cls, fast_batch, oracle_batch, what in (
        (SGAT, SGATDiag, sd32, cc_batch, "PPI clustered entries"),
        (FoutNet, FoutNetDiag, c_batch, cc_batch, "PPI clustered entries"),
        (SGAT, SGATBlockSparse, sw32, atomic_c, "atomic clustered 100k"),
        (FoutNet, FoutNetBlockSparse, cb_batch, atomic_c, "atomic clustered 100k"),
    ):
        oracle = oracle_cls(CLUSTERED["feat"], 2, 1, device=dev, generator=torch.Generator().manual_seed(3))
        fast = fast_cls(CLUSTERED["feat"], 2, 1, device=dev)
        for rule, context in (("shared ties", contextlib.nullcontext), ("full-cotangent ties", lambda: full_tie_pools(torch))):
            cross.append(
                cross_check(torch, f"{fast_cls.__name__} vs {oracle_cls.__name__}, {what} ({rule})", oracle, oracle_batch, fast, fast_batch, SGAT_FOUTNET_GATE, context, head_only)
            )
    emit({"phase": "sgat_foutnet_cross_checks", "checks": cross})
    return calls, f32_calls, sd_batch, sw_batch


def bf16_phases(torch, dev, card, counters, checks, peak, record, batches, undirected) -> tuple[list, list]:
    """Phases 27-32: the single-pass bf16 forms (compute_dtype=bfloat16) of
    K1, K2, K5, K6f and K6b against their plain versions on the card and
    their times, then the four bf16 train paths (each checked one step
    against the CPU, driven with the counters at 0 and profiled) and the
    clustered Diag GINet's bf16 step against the CPU. ``batches`` holds the
    dense, clustered Diag, BCSR, clustered BCSR, blocked and weighted
    (sgat_diag, sgat_bcsr) batches; ``undirected`` the edge counts of the
    dense and atomic graphs. Returns the timed calls of the paths and those
    of the forms no path runs."""
    import dataclasses
    import types

    import numpy as np

    from deeprank2_tpu_torch.neuralnets.gnn.clustered_blocksparse import GINetClusteredBlockSparse
    from deeprank2_tpu_torch.neuralnets.gnn.ginet_blocksparse import GINetBlockSparse
    from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetClusteredDiag, GINetDense
    from deeprank2_tpu_torch.neuralnets.gnn.vanilla_gnn import VanillaNetworkBlocked
    from deeprank2_tpu_torch.ops import block_sparse as bs
    from deeprank2_tpu_torch.ops import blocked_edges as be
    from deeprank2_tpu_torch.ops import diag_spmm as ds
    from deeprank2_tpu_torch.ops import vanilla as vn
    from deeprank2_tpu_torch.ops.batch import collate_graphs_blocked
    from deeprank2_tpu_torch.ops.losses import CrossEntropyLoss
    from deeprank2_tpu_torch.ops.synthetic import geometric_entry
    from deeprank2_tpu_torch.tools.timing import Timer

    bf = torch.bfloat16
    b = types.SimpleNamespace(**batches)

    # 27. the bf16 forms against their plain versions, at the paths' shapes and the largest N
    n_i8, n_bf = ds.max_nodes(torch.int8, dev, bf), ds.max_nodes(bf, dev, bf)
    adj_big, mask_i8_big = weighted_adjacency(torch, 4, n_i8, torch.float32, dev, seed=n_i8)
    adj_i8_big = adj_big.ne(0).to(torch.int8)
    adj_bf_big, mask_bf_big = weighted_adjacency(torch, 4, n_bf, bf, dev, seed=n_bf)
    pooled_f32 = dataclasses.replace(b.sw_batch.structure_p, blocks_t=b.sw_batch.structure_p.blocks_t.float())
    edgeless = {**geometric_entry(300, 38, 6, seed=3), "edge_index": np.zeros((0, 2), np.int64), "edge_attr": np.zeros((0, 6), np.float32)}
    ragged_bl, _ = collate_graphs_blocked([geometric_entry(700, 38, 6, seed=1), geometric_entry(1300, 38, 6, seed=2), edgeless], pad_graphs=4, device=dev)
    empty_bl, _ = collate_graphs_blocked([edgeless], device=dev)
    n, k = b.c_batch.adj_i8.shape[1], b.c_batch.adj_p_i8.shape[1]
    diag_shapes = [
        ("dense_bf16 G=512 N=160", b.dense_batch.adj_i8, b.dense_batch.node_mask, (32, 64)),
        (f"clustered_diag_bf16 G=512 N={n}", b.c_batch.adj_i8, b.c_batch.node_mask, (32,)),
        (f"clustered_diag_bf16 pooled G=512 K={k}", b.c_batch.adj_p_i8, b.c_batch.pooled_mask, (64,)),
        (f"sgat_diag adj_w bf16 G=512 N={b.sd_batch.adj_w.shape[1]}", b.sd_batch.adj_w, b.sd_batch.node_mask, (16,)),
        (f"largest int8 G=4 N={n_i8}", adj_i8_big, mask_i8_big, (32,)),
        (f"largest bf16 G=4 N={n_bf}", adj_bf_big, mask_bf_big, (16,)),
    ]
    bcsr_shapes = [
        (f"bcsr_bf16 {b.b_batch.structure.num_chunks} chunks", b.b_batch.structure, (32, 64)),
        (f"clustered_bcsr_bf16 full {b.cb_batch.structure.num_chunks} chunks", b.cb_batch.structure, (32,)),
        ("clustered_bcsr_bf16 pooled", b.cb_batch.structure_p, (64,)),
        ("sgat_bcsr full, bf16 blocks", b.sw_batch.structure, (16,)),
        ("sgat_bcsr pooled, f32 blocks (rounded to bf16)", pooled_f32, (32,)),
        ("bcsr_bf16 signed int8 {-2, -1, 0, 1, 3}", signed_structure(torch, b.b_batch.structure, seed=6), (32,)),
    ]
    blocked_shapes = [
        ("atomic 100k", b.bl_batch.structure, (32, 12)),
        ("ragged 700+1300+edgeless+empty graph", ragged_bl.structure, (32,)),
        ("no edges", empty_bl.structure, (32,)),
    ]
    n_checks = len(checks.rows)
    counters.reset()
    check_diag_kernels(torch, ds, checks, diag_shapes, dev, bf)
    check_bcsr_kernel(torch, bs, checks, bcsr_shapes, dev, bf)
    check_blocked_kernels(torch, be, vn, checks, blocked_shapes, dev, bf)
    forms, want = counters.read_forms(), expected_check_launches(ds, bs, diag_shapes, bcsr_shapes, bf, blocked_shapes)
    if forms != want:
        msg = f"the bf16 checks launched {forms}, expected {want}"
        raise AssertionError(msg)
    tolerance = {
        "K1, K2, K5 int8, K6f out, K6b dxr/dxc": TOL,
        "K5 weighted and signed int8": {"rtol": 1e-5, "atol": f"max(1e-5, {DW_TOL} * max |A| |x|)"},
        "K6b dw_e": {"rtol": 1e-5, "atol": f"{DW_TOL} * max sum_e |e_attr| |g[row]|"},
        "K6f out, K6b dxr/dxc against the ordered loop": EXACT,
    }
    emit({"phase": "bf16_kernel_checks", "tolerance": tolerance, "largest_nodes": {"int8/bfloat16": n_i8, "bfloat16/bfloat16": n_bf}, "launches_by_form": forms, "checks": checks.rows[n_checks:]})
    del adj_big, adj_i8_big, mask_i8_big, adj_bf_big, mask_bf_big, ragged_bl, empty_bl

    # 28. their times at the bf16 paths' calls (and the forms no path runs), beside the f32 forms
    timer = Timer()
    calls = time_diag_calls(torch, ds, timer, "dense_bf16", b.dense_batch.adj_i8, b.dense_batch.node_mask, STEP_CALLS["dense"], peak, bf)
    calls += time_bcsr_calls(torch, bs, timer, "bcsr_bf16", b.b_batch, BCSR_STEP_CALLS["bcsr"], peak, bf)
    calls += time_bcsr_calls(torch, bs, timer, "clustered_bcsr_bf16", b.cb_batch, BCSR_STEP_CALLS["clustered_bcsr"], peak, bf)
    calls += time_blocked_calls(torch, vn, timer, "blocked_bf16", b.bl_batch.structure, 32, 2, peak, bf)
    form_calls = time_diag_calls(
        torch, ds, timer, "bf16_adjacency", b.sd_batch.adj_w, b.sd_batch.node_mask, [("diag_kernel", "plain", 16, 0), ("pool_bwd_kernel", None, 16, 0)], peak, bf
    )
    form_calls += time_bcsr_calls(torch, bs, timer, "bf16_blocks", b.sw_batch, [("structure", 16, 0)], peak, bf)
    form_calls += time_bcsr_calls(torch, bs, timer, "f32_blocks", types.SimpleNamespace(structure_p=pooled_f32), [("structure_p", 32, 0)], peak, bf)
    del timer, pooled_f32
    emit({"phase": "bf16_kernel_times", "card": card, "l2_flushed": True, "calls": calls, "no_path_calls": form_calls})

    # 29-32. the four bf16 paths, each checked against the CPU, counted and profiled
    steps = BCSR_STEPS
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    paths = (
        ("dense_bf16", b.dense_batch, lambda d: GINetDense(38, 2, 6, device=d, generator=gen(), compute_dtype=bf), "GINetDense(38, 2, 6, bf16)",
         {"diag_kernel": 3 * steps + 2, "pool_bwd_kernel": steps}, {"diag_kernel[int8/bfloat16]": 3 * steps + 2, "pool_bwd_kernel[int8/bfloat16]": steps},
         {**BENCH}, undirected["dense"], None),
        ("bcsr_bf16", b.b_batch, lambda d: GINetBlockSparse(38, 2, 6, device=d, generator=gen(), compute_dtype=bf), "GINetBlockSparse(38, 2, 6, bf16)",
         {"bcsr_spmm_kernel": 4 * steps + 2}, {"bcsr_spmm_kernel[int8/bfloat16]": 4 * steps + 2}, {**BCSR}, undirected["bcsr"], None),
        ("clustered_bcsr_bf16", b.cb_batch, lambda d: GINetClusteredBlockSparse(38, 2, 1, device=d, generator=gen(), compute_dtype=bf),
         "GINetClusteredBlockSparse(38, 2, 1, bf16)", {"bcsr_spmm_kernel": 4 * steps + 2, "slot_fwd_kernel": steps + 1, "slot_bwd_kernel": steps},
         {"bcsr_spmm_kernel[int8/bfloat16]": 4 * steps + 2}, {**CLUSTERED_BCSR}, undirected["clustered_bcsr"], lambda *a: bcsr_winner_flips(torch, bs, *a)),
        ("blocked_bf16", b.bl_batch, lambda d: VanillaNetworkBlocked(38, 2, 6, device=d, generator=gen(), compute_dtype=bf), "VanillaNetworkBlocked(38, 2, 6, bf16)",
         {"blocked_fwd_kernel": 2 * steps + 2, "blocked_bwd_kernel": 2 * steps}, {"blocked_fwd_kernel[bfloat16]": 2 * steps + 2, "blocked_bwd_kernel[bfloat16]": 2 * steps},
         {**BCSR}, undirected["bcsr"], None),
    )  # fmt: skip
    for name, batch, factory, model_name, counts, forms_want, batch_info, n_undirected, flips in paths:
        record(name, checked_path(
            torch,
            counters,
            card,
            batch,
            factory,
            want_launches(**counts),
            dev,
            f"main_path_{name}",
            {"model": model_name, "batch": batch_info, "collate_s": None, "undirected_edges": n_undirected},
            flips=flips,
            steps=steps,
            want_forms=forms_want,
            grad_tol=BF16_STEP_TOL,
            tol=BF16_STEP_TOL,
        ))

    # the clustered Diag GINet's bf16 step against the CPU
    model = GINetClusteredDiag(CLUSTERED["feat"], 2, 1, device=dev, generator=gen(), compute_dtype=bf)
    step, cpu_model, cpu_batch = card_vs_cpu_step(
        torch, model, b.c_batch, CrossEntropyLoss(), lambda: GINetClusteredDiag(CLUSTERED["feat"], 2, 1, device="cpu", compute_dtype=bf), BF16_STEP_TOL, BF16_STEP_TOL
    )
    emit({"phase": "clustered_diag_bf16_card_vs_cpu_step", "tolerance": BF16_STEP_TOL, "grad_tolerance": BF16_STEP_TOL, **step})
    del model, cpu_model, cpu_batch
    return calls, form_calls


def check_bf16_tower_kernels(torch, gt, ds, checks, shapes, w1, w2, dev) -> None:
    """The bf16 forms of K8f/K8b and K9f/K9b against their plain versions
    (which round at the same points), directly and through ginet_tower_pooled
    and tower_pooled, at Checks.close_flips's gate: f32 order against
    Σ|terms| (the same output on the absolute operands, or dw_error_scale /
    tower_bwd_error_scale) except a counted share of bf16 flips; t2 and t1
    must come back as bf16; K9f's sign may differ only where |h2| is within
    FLIP x Σ|terms| of zero, on at most FLIP_SHARE of the entries.
    ``shapes`` as check_tower_kernels takes them."""
    bf = torch.bfloat16
    form = ds.form_name(torch.int8, bf)
    for tag, b in shapes["batched"]:
        g = b.x.shape[0]
        gen = torch.Generator(device=dev).manual_seed(len(checks.rows))
        dp = torch.randn(g, w2.shape[1], generator=gen, device=dev)
        args = (w1, w2, b.x, b.adj_i8, b.node_mask)
        fwd_ref = gt.ginet_tower_fwd_kernel_ref(*args, bf)
        fwd_scale = gt.ginet_tower_fwd_kernel_ref(w1.abs(), w2.abs(), b.x.abs(), b.adj_i8, b.node_mask, bf)
        checks.close_flips("ginet_tower_fwd_kernel", f"{tag} direct", gt.ginet_tower_fwd_kernel(*args, bf), fwd_ref, fwd_scale, form)
        bwd_ref, scales = gt.ginet_tower_bwd_kernel_ref(*args, dp, bf), gt.dw_error_scale(*args, dp, bf)
        direct = gt.ginet_tower_bwd_kernel(*args, dp, bf)
        a, c = w1.clone().requires_grad_(True), w2.clone().requires_grad_(True)
        out = gt.ginet_tower_pooled(a, c, *args[2:], bf)
        grads = torch.autograd.grad(out, (a, c), dp)
        checks.close_flips("ginet_tower_fwd_kernel", f"{tag} ginet_tower_pooled fwd", out.detach(), fwd_ref, fwd_scale, form)
        for what, got_d, got_f, want, scale in zip(("dw1", "dw2"), direct, grads, bwd_ref, scales):
            checks.close_flips("ginet_tower_bwd_kernel", f"{tag} direct {what}", got_d, want, scale, form)
            checks.close_flips("ginet_tower_bwd_kernel", f"{tag} ginet_tower_pooled vjp {what}", got_f, want, scale, form)
        del direct, grads
    for tag, b in shapes["flat"]:
        gen = torch.Generator(device=dev).manual_seed(len(checks.rows))
        dp = torch.randn(b.x.shape[0], w2.shape[1], generator=gen, device=dev)
        fargs = (b.adj_i8, b.x_t, b.node_mask, w1, w2)
        h1, sign, pooled = ds.tower_fwd_kernel(*fargs, bf)
        h1_r, sign_r, pooled_r = ds.tower_fwd_kernel_ref(*fargs, bf)
        h1_s, _, pooled_s = ds.tower_fwd_kernel_ref(b.adj_i8, b.x_t.abs(), b.node_mask, w1.abs(), w2.abs(), bf)
        checks.close_flips("tower_fwd_kernel", f"{tag} direct h1", h1, h1_r, h1_s, form)
        checks.close_flips("tower_fwd_kernel", f"{tag} direct pooled", pooled, pooled_r, pooled_s, form)
        # h1 and the sign of h2 in the kernel's order and roundings: bit for bit
        h1_o, sign_o = ds.tower_fwd_order_ref(*fargs, bf)
        checks.close("tower_fwd_kernel", f"{tag} h1 vs the order loop", h1, h1_o, EXACT, form)
        checks.close("tower_fwd_kernel", f"{tag} sign vs the order loop", sign, sign_o, EXACT, form)
        del h1_o, sign_o
        rw2 = ds.round_to(w2, bf)
        h2 = torch.relu(ds.diag_kernel_ref(b.adj_i8, rw2.T @ ds.round_to(h1_r, bf), compute_dtype=bf)) * b.node_mask.reshape(1, -1)
        h2_s = ds.diag_kernel_ref(b.adj_i8, rw2.abs().T @ ds.round_to(h1_s, bf), compute_dtype=bf)
        differ = sign != sign_r
        n_differ, beyond = int(differ.sum().item()), int((differ & (h2 > FLIP * h2_s)).sum().item())
        checks.rows.append({"kernel": "tower_fwd_kernel", "check": f"{tag} sign", "form": form, "sign_differs": n_differ, "beyond_the_flip_band": beyond, "entries": sign.numel()})
        if beyond or n_differ > FLIP_SHARE * sign.numel():
            msg = f"tower_fwd_kernel {tag}: the bf16 sign differs at {n_differ} values, {beyond} of them beyond a flip of h2"
            raise AssertionError(msg)
        g_pool = dp.T.contiguous()
        bwd = (b.adj_i8, g_pool, sign_r, h1_r, w2)
        t_ref = ds.tower_bwd_kernel_ref(*bwd, bf)
        for what, got, want, scale in zip(("t2", "t1"), ds.tower_bwd_kernel(*bwd, bf), t_ref, ds.tower_bwd_error_scale(*bwd, bf)):
            if got.dtype != bf:
                msg = f"tower_bwd_kernel {tag}: {what} is {got.dtype}, expected bf16"
                raise AssertionError(msg)
            checks.close_flips("tower_bwd_kernel", f"{tag} direct {what}", got.float(), want.float(), scale, form)
        # through tower_pooled: the VJP's weight gradients are f32 products of
        # x_t and h1 with the bf16 t1 and t2 widened
        a, c = w1.clone().requires_grad_(True), w2.clone().requires_grad_(True)
        out = ds.tower_pooled(b.adj_i8, b.node_mask, b.x_t, a, c, bf)
        grads = torch.autograd.grad(out, (a, c), g_pool)
        t2_r, t1_r = (t.float() for t in t_ref)
        checks.close_flips("tower_fwd_kernel", f"{tag} tower_pooled fwd", out.detach(), pooled_r, pooled_s, form)
        for what, got, want, scale in zip(("dw1", "dw2"), grads, (b.x_t @ t1_r.T, h1_r @ t2_r.T), (b.x_t.abs() @ t1_r.abs().T, h1_r.abs() @ t2_r.abs().T)):
            checks.close_flips("tower_bwd_kernel", f"{tag} tower_pooled vjp {what}", got, want, scale, form)
        del grads, h1, sign, pooled, h1_r, sign_r, pooled_r, h1_s, pooled_s, h2, h2_s, t_ref
    sync(torch, dev)


def bf16_tower_phases(torch, dev, card, counters, checks, peak, record, dense_batch, tower_shapes, loss_fn, real_edges) -> list:
    """Phases 33-36: the bf16 forms of K8f, K8b, K9f and K9b against their
    plain versions (``tower_shapes``: the bench, ragged N=33, ragged N=96
    and each family's largest-N batches) and their times beside the f32 forms and the flat route's bf16
    K1/K2, then the dense_tower_bf16 path (GINetDense with
    compute_dtype=bfloat16 on the "pallas" tower: checked one step against
    the CPU, driven with the counters at 0, profiled) and the
    dense_fused_tower_bf16 drive (tower_pooled in bf16). Returns the timed
    calls."""
    from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetDense, set_dense_tower_backend
    from deeprank2_tpu_torch.ops import diag_spmm as ds
    from deeprank2_tpu_torch.ops import ginet_tower as gt
    from deeprank2_tpu_torch.ops.optim import Adam
    from deeprank2_tpu_torch.tools.timing import Timer

    bf = torch.bfloat16
    model = GINetDense(BENCH["feat"], 2, BENCH["edge_dim"], device=dev, generator=torch.Generator().manual_seed(0))
    w1, w2 = tower_weights(model)
    del model

    # 33. the bf16 tower forms against their plain versions
    n_checks = len(checks.rows)
    counters.reset()
    check_bf16_tower_kernels(torch, gt, ds, checks, tower_shapes, w1, w2, dev)
    forms, k_batched, k_flat = counters.read_forms(), 2 * len(tower_shapes["batched"]), 2 * len(tower_shapes["flat"])
    want = {f"{kernel}[int8/bfloat16]": k_batched for kernel in ("ginet_tower_fwd_kernel", "ginet_tower_bwd_kernel")}
    want.update({f"{kernel}[int8/bfloat16]": k_flat for kernel in ("tower_fwd_kernel", "tower_bwd_kernel")})
    if forms != want:
        msg = f"the bf16 tower checks launched {forms}, expected {want}"
        raise AssertionError(msg)
    tolerance = {"every output": f"f32 order (rtol 1e-5, atol {DW_TOL} * sum |terms|) but at most {FLIP_SHARE:g} of the entries, each within {FLIP} * (sum |terms| + |value|)", "sign": f"differs only where |h2| <= {FLIP} * sum |terms|"}
    emit({"phase": "bf16_tower_kernels_vs_plain", "tolerance": tolerance, "launches_by_form": forms, "checks": checks.rows[n_checks:]})

    # 34. their times beside the f32 forms and the flat route's bf16 K1/K2
    timer = Timer()
    calls = time_tower_calls(torch, gt, ds, timer, dense_batch, w1, w2, peak, bf)
    del timer
    emit({"phase": "bf16_tower_kernel_times", "card": card, "l2_flushed": True, "calls": calls})

    # 35. the dense path on the batched tower backend in bf16, and its profile
    set_dense_tower_backend("pallas")
    try:
        model = GINetDense(BENCH["feat"], 2, BENCH["edge_dim"], device=dev, generator=torch.Generator().manual_seed(0), compute_dtype=bf)
        step, _, _ = card_vs_cpu_step(
            torch, model, dense_batch, loss_fn, lambda: GINetDense(BENCH["feat"], 2, BENCH["edge_dim"], device="cpu", compute_dtype=bf), BF16_STEP_TOL, BF16_STEP_TOL
        )
        emit({"phase": "dense_tower_bf16_card_vs_cpu_step", "tolerance": BF16_STEP_TOL, **step})
        opt = Adam(model.parameters(), lr=1e-3, weight_decay=1e-5)
        want = want_launches(ginet_tower_fwd_kernel=STEPS + 1, ginet_tower_bwd_kernel=STEPS)
        want_forms = {"ginet_tower_fwd_kernel[int8/bfloat16]": STEPS + 1, "ginet_tower_bwd_kernel[int8/bfloat16]": STEPS}
        run = run_main_path(torch, counters, model, dense_batch, loss_fn, opt, dev, want, STEPS, want_forms=want_forms)
        train_step = run.pop("train_step")
        emit({"phase": "main_path_dense_tower_bf16", "card": card, "model": "GINetDense(38, 2, 6, bf16), tower backend pallas", "batch": BENCH, **run, "step_ms": run["step_s"] * 1e3, "edges_per_s": real_edges / run["step_s"], "real_edges": real_edges})
        record("dense_tower_bf16", run)
        emit({"phase": "profile_dense_tower_bf16", "card": card, **profile_steps(torch, train_step, run["step_s"])})
        del model, opt, train_step
    finally:
        set_dense_tower_backend("xla")

    # 36. the fused flat tower (tower_pooled) in bf16 on the bench batch
    fused = fused_tower_drive(torch, ds, None, None, counters, dense_batch, w1, w2, STEPS, dev, bf)
    emit({"phase": "dense_fused_tower_bf16", "card": card, "weights": "GINetDense(38, 2, 6) fused, torch seed 0", "batch": BENCH, "compute_dtype": "bfloat16", **fused})
    record("dense_fused_tower_bf16", fused)
    return calls


def bf16_sgat_foutnet_phases(torch, dev, card, counters, peak, record, c_entries, c_batch, sd_batch, c_entry, cb_batch, sw_batch) -> list:
    """Phases 37-41: the FoutNet and sGAT paths with compute_dtype=bfloat16
    (K1's bf16 form on the int8 and bf16 adjacencies, K5's on the int8 and
    bf16 blocks): their kernel calls timed beside the f32 forms, then each
    path checked one step against the CPU at BF16_STEP_TOL (the 100k-node
    ones on clustered_entry(20_000, 38, 1)), driven with the counters at 0
    (4 S + 2 launches of its bf16 K1/K5 form, K3 S + 1 and K4 S) and
    profiled; then SGATDiag in bf16 on the f32 adjacency of
    weight_dtype=float32 (JAX's XLA fallback) against the CPU. Returns the
    timed calls."""
    from deeprank2_tpu_torch.neuralnets.gnn.clustered_blocksparse import FoutNetBlockSparse, SGATBlockSparse
    from deeprank2_tpu_torch.neuralnets.gnn.foutnet import FoutNetDiag
    from deeprank2_tpu_torch.neuralnets.gnn.sgat import SGATDiag
    from deeprank2_tpu_torch.ops import block_sparse as bs
    from deeprank2_tpu_torch.ops import diag_spmm as ds
    from deeprank2_tpu_torch.ops.batch import collate_graphs_blocksparse_clustered, collate_graphs_diag_clustered
    from deeprank2_tpu_torch.ops.losses import CrossEntropyLoss
    from deeprank2_tpu_torch.ops.synthetic import clustered_entry
    from deeprank2_tpu_torch.tools.timing import Timer

    bf = torch.bfloat16
    steps = SGAT_FOUTNET_STEPS

    # 37. the paths' bf16 K1 and K5 calls, beside the f32 forms
    timer = Timer()
    calls = []
    for path, batch, full, pooled in (("sgat_diag_bf16", sd_batch, sd_batch.adj_w, sd_batch.adj_wp), ("foutnet_diag_bf16", c_batch, c_batch.adj_i8, c_batch.adj_p_i8)):
        calls += time_diag_calls(torch, ds, timer, path, full, batch.node_mask, [("diag_kernel", "plain", 16, 2)], peak, bf)
        calls += time_diag_calls(torch, ds, timer, f"{path}_pooled", pooled, batch.pooled_mask, [("diag_kernel", "plain", 32, 2)], peak, bf)
    bcsr_specs = [("structure", 16, 2), ("structure_p", 32, 2)]
    calls += time_bcsr_calls(torch, bs, timer, "sgat_bcsr_bf16", sw_batch, bcsr_specs, peak, bf)
    calls += time_bcsr_calls(torch, bs, timer, "foutnet_bcsr_bf16", cb_batch, bcsr_specs, peak, bf)
    del timer
    emit({"phase": "bf16_sgat_foutnet_kernel_times", "card": card, "l2_flushed": True, "calls": calls})

    # 38-41. the four paths, each checked against the CPU, counted and profiled
    per_path = want_launches(slot_fwd_kernel=steps + 1, slot_bwd_kernel=steps)
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    diag_undirected = int(sum(e["edge_index"].shape[0] for e in c_entries))
    for name, cls, batch in (("sgat_diag_bf16", SGATDiag, sd_batch), ("foutnet_diag_bf16", FoutNetDiag, c_batch)):
        form = ds.form_name(batch.adj_w.dtype if cls is SGATDiag else batch.adj_i8.dtype, bf)
        record(name, checked_path(
            torch,
            counters,
            card,
            batch,
            lambda d, cls=cls: cls(CLUSTERED["feat"], 2, 1, device=d, generator=gen(), compute_dtype=bf),
            {**per_path, "diag_kernel": 4 * steps + 2},
            dev,
            f"main_path_{name}",
            {
                "model": f"{cls.__name__}(38, 2, 1, bf16)",
                "batch": {**CLUSTERED, "weighted": cls is SGATDiag, "form": form, "adj": list(batch.adj_i8.shape), "adj_p": list(batch.adj_p_i8.shape)},
                "collate_s": None,
                "undirected_edges": diag_undirected,
            },
            steps=steps,
            want_forms={f"diag_kernel[{form}]": 4 * steps + 2},
            grad_tol=BF16_STEP_TOL,
            tol=BF16_STEP_TOL,
        ))
    small = clustered_entry(SGAT_FOUTNET_CHECK_NODES, 38, 1, seed=CLUSTERED_BCSR["seed"])
    for name, cls, batch in (("sgat_bcsr_bf16", SGATBlockSparse, sw_batch), ("foutnet_bcsr_bf16", FoutNetBlockSparse, cb_batch)):
        weighted = cls is SGATBlockSparse
        form = bs.form_name(batch.structure.blocks_t.dtype, bf)
        check_batch, _ = collate_graphs_blocksparse_clustered([small], with_edge_weights=weighted, slot8=True, device=dev)
        record(name, checked_path(
            torch,
            counters,
            card,
            batch,
            lambda d, cls=cls: cls(CLUSTERED_BCSR["feat"], 2, 1, device=d, generator=gen(), compute_dtype=bf),
            {**per_path, "bcsr_spmm_kernel": 4 * steps + 2},
            dev,
            f"main_path_{name}",
            {
                "model": f"{cls.__name__}(38, 2, 1, bf16)",
                "batch": {**CLUSTERED_BCSR, "weighted": weighted, "form": form, "blocks_nonzero": batch.structure.tile_blocks.numel()},
                "collate_s": None,
                "undirected_edges": int(c_entry["edge_index"].shape[0]),
                "check_batch": f"clustered_entry({SGAT_FOUTNET_CHECK_NODES}, 38, 1), slot8",
            },
            steps=steps,
            want_forms={f"bcsr_spmm_kernel[{form}]": 4 * steps + 2},
            check_batch=check_batch,
            grad_tol=BF16_STEP_TOL,
            tol=BF16_STEP_TOL,
        ))
        del check_batch

    # SGATDiag in bf16 on the f32 adjacency: K1's bf16 form on the adjacency
    # rounded to bf16, its output rounded (four launches of bfloat16/bfloat16)
    sd32, _ = collate_graphs_diag_clustered(c_entries, with_edge_weights=True, weight_dtype=torch.float32, device=dev)
    model = SGATDiag(CLUSTERED["feat"], 2, 1, device=dev, generator=gen(), compute_dtype=bf)
    counters.reset()
    step, cpu_model, cpu_batch = card_vs_cpu_step(
        torch, model, sd32, CrossEntropyLoss(), lambda: SGATDiag(CLUSTERED["feat"], 2, 1, device="cpu", compute_dtype=bf), BF16_STEP_TOL, BF16_STEP_TOL
    )
    forms = counters.read_forms()
    if forms != {"diag_kernel[bfloat16/bfloat16]": 4}:
        msg = f"SGATDiag bf16 on the f32 adjacency launched {forms}, expected diag_kernel[bfloat16/bfloat16] 4"
        raise AssertionError(msg)
    emit({"phase": "sgat_diag_bf16_f32_adjacency_card_vs_cpu_step", "tolerance": BF16_STEP_TOL, "grad_tolerance": BF16_STEP_TOL, "adj_w": str(sd32.adj_w.dtype), "launches_by_form": forms, **step})
    del model, cpu_model, cpu_batch, sd32
    return calls


class Recorder:
    """An output exporter of the Trainer that keeps every pass: its name,
    epoch, outputs by entry and loss."""

    def __init__(self):
        self.passes = []

    def __enter__(self):
        return self

    def __exit__(self, *exc_info) -> None:
        pass

    def is_compatible_with(self, output_data_shape, target_data_shape=None) -> bool:  # noqa: ARG002
        return True

    def process(self, pass_name, epoch_number, entry_names, output_values, target_values, loss) -> None:  # noqa: ARG002
        self.passes.append({"pass": pass_name, "epoch": epoch_number, "outputs": dict(zip(entry_names, output_values)), "loss": loss})


def in_memory_dataset(entries, train_source=None, clustering_method=None, node_features=("x",), edge_features=("edge_attr",)):
    """A ``GraphDataset`` over ``entries`` held in memory: the card's machine
    has no h5py, so no HDF5 file is written or read
    (``parallel/probes.py:in_memory_dataset``, which the spawned ranks use
    too)."""
    from deeprank2_tpu_torch.parallel.probes import in_memory_dataset as dataset

    return dataset(entries, train_source, clustering_method, node_features, edge_features)


def in_memory_grid_dataset(entries, train_source=None, clustering_method=None, features=None):  # noqa: ARG001 — grids have no clusters
    """A ``GridDataset`` over grid entries (``x [C, W, H, D]``) held in memory,
    as :func:`in_memory_dataset` for graphs: binary classification, one
    feature name a channel (``features``, else ``mapped_000``...),
    ``load_one_grid`` returning the entry itself."""
    from deeprank2_tpu_torch.dataset import GridDataset

    class InMemoryGridDataset(GridDataset):
        def __init__(self):  # noqa: PLW0231 — the file checks of the parent are what this replaces
            self.hdf5_paths, self.subset, self.train_source = ["in-memory"], None, train_source
            self.target, self.target_transform, self.target_filter = "binary", False, None
            self.root, self.use_tqdm = "./", False
            self._check_task_and_classes("classif", None)
            self._entries = {e["entry_name"]: e for e in entries}
            self.index_entries = [("in-memory", e["entry_name"]) for e in entries]
            self.df = self.means = self.devs = self.train_means = self.train_devs = None
            self._cache, self._cache_capacity = {}, 16384
            self.features = list(features) if features is not None else [f"mapped_{i:03d}" for i in range(entries[0]["x"].shape[0])]
            self.inherited_params = None

        def load_one_grid(self, fname, entry_name):  # noqa: ARG002
            return self._entries[entry_name]

    return InMemoryGridDataset()


def in_memory_trainer(model_cls, entries, clustered, dataset=in_memory_dataset, **kwargs):
    """A Trainer of ``model_cls`` on ``entries`` held in memory (``dataset``
    makes the dataset: :func:`in_memory_dataset` or
    :func:`in_memory_grid_dataset`).

    A clustered model's Trainer preclusters its datasets (``_precluster``:
    community detection on each entry, its ids written into the entry's
    HDF5 file). This machine has no h5py, and the synthetic entries already
    carry the cluster ids of their generator (``clustered_entry``,
    ``ppi_clustered_entries``), which the collates read; so here a subclass
    replaces ``_precluster`` with a check that every entry has them. A
    clustered Trainer also gets a validation set, so that it does not split
    one off the training entries."""
    from deeprank2_tpu_torch.trainer import Trainer

    class PreclusteredTrainer(Trainer):
        def _precluster(self, dataset) -> None:
            missing = [name for (_, name), i in zip(dataset.index_entries, range(len(dataset))) if dataset.get(i).get("cluster0") is None]
            if missing:
                msg = f"entries without cluster ids: {missing}"
                raise AssertionError(msg)

    method = "mcl" if clustered else None
    train = dataset(entries, clustering_method=method)
    val = dataset(entries[:1], train_source=train, clustering_method=method) if clustered else None
    return PreclusteredTrainer(model_cls, dataset_train=train, dataset_val=val, seed=0, **kwargs)


def expected_buckets(requirements) -> dict:
    """The Trainer's grow-only capacity buckets after batches of these
    requirements (dicts keyed as the buckets), in order."""
    import types

    from deeprank2_tpu_torch.trainer import Trainer

    holder = types.SimpleNamespace(_bs_caps={})
    for req in requirements:
        for key, required in req.items():
            Trainer._blocksparse_bucket(holder, key)(required)
    return holder._bs_caps


def trainer_phase(torch, counters, spec: dict) -> dict:
    """One model through ``Trainer.train`` on the card, on datasets held in
    memory (``spec["dataset"]``, :func:`in_memory_dataset` by default), in
    three parts:

    1. a dropout-free Trainer on the card and one on the CPU from the same
       weights, one epoch of ``spec["check"]`` in batches of
       ``spec["check_batch_size"]`` each: the epoch-0 logits and the passes'
       losses at CROSS_TOL, the last step's gradients at ``spec["grad_tol"]``
       (or, where the epoch is one step, by ``spec["grad_gate"](initial
       state, card Trainer, gradients by side)``, against float64),
       the card Trainer's launches by form, a step, as ``spec["step_forms"]``
       (every kernel's ``spec["step"]``, ``spec["eval"]`` an epoch-0 eval
       batch);
    2. unless ``spec["epochs"]`` is 0, that many epochs of ``spec["entries"]``
       shuffled in batches of ``spec["batch_size"]``, with the counters at 0:
       the same launches a step in each train pass, no host sync in one
       (torch.cuda's sync debug mode over the pass's loop), the first epoch
       profiled (``profile_dir``: device busy time from its trace, the idle
       share), the train-pass time a step of the later epochs beside the
       bare loop's step ``spec["bare_step_s"]``, the loader's collate seconds
       and batch bytes (the pinned copy the card gets) a batch, and the
       grow-only buckets against ``spec["buckets"]`` where given;
    3. the checkpoint the last card Trainer wrote, reloaded by
       ``Trainer(..., pretrained_model=...)`` on the card: its ``test()``
       outputs on ``spec["check"]`` equal the trained model's at CKPT_TOL.
    """
    import tempfile
    import warnings

    from deeprank2_tpu_torch.trainer import Trainer
    from deeprank2_tpu_torch.utils.exporters import OutputExporterCollection

    model_cls, clustered, name = spec["model"], spec["clustered"], spec["name"]
    dataset = spec.get("dataset", in_memory_dataset)
    step_counts, eval_counts = spec["step"], spec["eval"]
    tmp = tempfile.TemporaryDirectory()
    ckpt = str(Path(tmp.name) / "model.pth.tar")
    out = {"dataset": "in-memory (no h5py on this machine)", "entries": len(spec["entries"]), "batch_size": spec["batch_size"]}
    errs = {}

    def close(what, got, want, tol):
        errs[what] = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, **tol, msg=lambda m: f"{name} card vs CPU {what}: {m}")

    def check_pass(what, launches, forms, steps, batches):
        want = {k: step_counts.get(k, 0) * steps + eval_counts.get(k, 0) * batches for k in KERNELS}
        want_forms = {k: n * steps for k, n in spec["step_forms"].items()}
        want_forms = {k: n + spec["eval_forms"].get(k, 0) * batches for k, n in want_forms.items()}
        if {k: launches.get(k, 0) for k in KERNELS} != want or {k: n for k, n in forms.items() if n} != {k: n for k, n in want_forms.items() if n}:
            msg = f"{name} {what}: launches {launches} by form {forms}, expected {want} by form {want_forms}"
            raise AssertionError(msg)

    # 1. card against CPU: one dropout-free epoch from the same weights
    no_dropout = type(model_cls.__name__, (model_cls,), {"dropout": 0.0})
    logits, recs, trainers = {}, {}, {}
    for side, device in (("card", None), ("cpu", "cpu")):
        recs[side], logits[side] = Recorder(), []
        t = in_memory_trainer(no_dropout, spec["check"], clustered, dataset, output_exporters=[recs[side]], device=device)
        build = t._build_step_functions

        def build_and_record(t=t, build=build, store=logits[side]):
            build()
            step = t._eval_step

            def recorded(batch):
                loss, pred = step(batch)
                store.append(pred.detach().cpu())
                return loss, pred

            t._eval_step = recorded

        t._build_step_functions = build_and_record
        trainers[side] = t
    trainers["cpu"].model.load_state_dict({k: v.cpu() for k, v in trainers["card"].model.state_dict().items()})
    trainers["cpu"].configure_optimizers()
    initial = {k: v.detach().clone() for k, v in trainers["card"].model.state_dict().items()}
    cbs = spec["check_batch_size"]
    for side, t in trainers.items():
        sync(torch, torch.device("cuda"))
        counters.reset()
        t.train(nepoch=1, batch_size=cbs, shuffle=False, filename=ckpt if side == "card" and not spec["epochs"] else None)
        sync(torch, torch.device("cuda"))
        if side == "card":
            check_launches, check_forms = counters.read(), counters.read_forms()
    n_check = -(-len(spec["check"]) // cbs)
    check_pass("card-vs-CPU epoch", check_launches, check_forms, n_check, n_check)
    for i, (a, b) in enumerate(zip(logits["card"][:n_check], logits["cpu"][:n_check])):
        close(f"epoch-0 logits, batch {i}", a, b, CROSS_TOL)
    losses = {side: [p["loss"] for p in recs[side].passes] for side in recs}
    close("pass losses", torch.tensor(losses["card"]), torch.tensor(losses["cpu"]), CROSS_TOL)
    grads = {side: {k: p.grad.detach().cpu() for k, p in t.model.named_parameters() if p.grad is not None} for side, t in trainers.items()}
    if grads["card"].keys() != grads["cpu"].keys():
        msg = f"{name}: the Trainers' gradients differ in which parameters have one: {sorted(grads['card'])} vs {sorted(grads['cpu'])}"
        raise AssertionError(msg)
    if "grad_gate" in spec:
        # the gradients of the epoch's one step, against float64 at the initial weights
        if n_check != 1:
            msg = f"{name}: grad_gate holds the gradients of one step; the check epoch has {n_check}"
            raise AssertionError(msg)
        out["grad_gate"] = spec["grad_gate"](initial, trainers["card"], grads)
    else:
        for k in grads["card"]:
            close(f"last step grad {k}", grads["card"][k], grads["cpu"][k], spec["grad_tol"])
    out["card_vs_cpu"] = {
        "entries": len(spec["check"]),
        "batch_size": cbs,
        "tolerance": {"logits_and_losses": CROSS_TOL, "grads": spec.get("grad_tol", "float64, tools/f64_gate.py's per-entry gate")},
        "pass_losses": losses,
        "launches": check_launches,
        "launches_by_form": check_forms,
    }
    launches, forms, t = check_launches, check_forms, trainers["card"]
    del trainers, logits, grads

    # 2. the timed run: launches and host syncs of each train pass
    if spec["epochs"]:
        rec = Recorder()
        t = in_memory_trainer(model_cls, spec["entries"], clustered, dataset, output_exporters=[rec])
        epoch, iter_batches = t._epoch, t._iter_batches
        train_passes, in_train = [], [False]

        def counted_epoch(*args, **kwargs):
            sync(torch, t.device)
            before, before_forms = counters.read(), counters.read_forms()
            in_train[0] = True
            try:
                loss = epoch(*args, **kwargs)
            finally:
                in_train[0] = False
            sync(torch, t.device)
            after, after_forms = counters.read(), counters.read_forms()
            train_passes[-1]["launches"] = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            train_passes[-1]["launches_by_form"] = {k: n - before_forms.get(k, 0) for k, n in after_forms.items() if n != before_forms.get(k, 0)}
            return loss

        def synced_iter_batches(*args, **kwargs):
            if not in_train[0]:
                yield from iter_batches(*args, **kwargs)
                return
            # every operation of the pass's loop that makes the host wait for
            # the device (the drain after the loop reads the results, on purpose)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    yield from iter_batches(*args, **kwargs)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            train_passes.append({"host_syncs": sync_sites(caught)})

        t._epoch, t._iter_batches = counted_epoch, synced_iter_batches
        bs, epochs = spec["batch_size"], spec["epochs"]
        sync(torch, t.device)
        counters.reset()
        t.train(nepoch=epochs, batch_size=bs, shuffle=True, filename=ckpt, profile_dir=tmp.name)
        sync(torch, t.device)
        launches, forms = counters.read(), counters.read_forms()
        per_epoch = -(-len(spec["entries"]) // bs)
        check_pass("timed run", launches, forms, epochs * per_epoch, per_epoch)
        for i, p in enumerate(train_passes, start=1):
            check_pass(f"epoch {i}", p["launches"], p["launches_by_form"], per_epoch, 0)
            if p["host_syncs"]:
                msg = f"{name} epoch {i}: {len(p['host_syncs'])} host syncs in the train pass: {p['host_syncs']}"
                raise AssertionError(msg)
        stats = {(p["pass"], p["epoch"]): p for p in t.pass_stats}
        timed = [stats["training", e] for e in range(2, epochs + 1)]
        step_s = sum(p["seconds"] for p in timed) / sum(p["batches"] for p in timed)
        train_stats = [stats["training", e] for e in range(1, epochs + 1)]
        collate = [c for p in train_stats for c in p["collate_s"]]
        batch_bytes = [b for p in train_stats for b in p["batch_bytes"]]
        trace = json.loads((Path(tmp.name) / "epoch1.trace.json").read_text())
        busy_by_cat = {c: sum(e.get("dur", 0) for e in trace["traceEvents"] if e.get("cat") == c) for c in ("kernel", "gpu_memcpy", "gpu_memset")}
        busy_us = sum(busy_by_cat.values())
        first = stats["training", 1]
        pass_losses = [p["loss"] for p in rec.passes]
        if not all(math.isfinite(x) for x in pass_losses):
            msg = f"{name}: non-finite pass losses {pass_losses}"
            raise AssertionError(msg)
        caps = getattr(t, "_bs_caps", None)
        if spec.get("buckets") is not None and caps != spec["buckets"]:
            msg = f"{name}: the Trainer's buckets {caps}, expected {spec['buckets']} from the entries' requirements"
            raise AssertionError(msg)
        out.update(
            {
                "epochs": epochs,
                "steps": epochs * per_epoch,
                "train_pass_s_per_step": step_s,
                "train_pass_ms_per_step": step_s * 1e3,
                "train_loop_ms_per_step": 1e3 * sum(p["loop_s"] for p in timed) / sum(p["batches"] for p in timed),
                "bare_loop_step_ms": spec["bare_step_s"] * 1e3 if spec.get("bare_step_s") else None,
                "trainer_over_bare_loop": step_s / spec["bare_step_s"] if spec.get("bare_step_s") else None,
                "launches": launches,
                "launches_by_form": forms,
                "train_passes": train_passes,
                "host_syncs_per_train_pass": [len(p["host_syncs"]) for p in train_passes],
                "collate_s_per_batch": statistics.mean(collate),
                "collate_s": collate,
                "batch_mb_per_batch": statistics.mean(batch_bytes) / 1e6,
                "batch_mb": [b / 1e6 for b in batch_bytes],
                "buckets": caps,
                "profiled_epoch": {
                    "traced_s": first["seconds"],
                    "device_busy_ms_per_step": busy_us / 1e3 / first["batches"],
                    "device_busy_ms_per_step_by_category": {c: us / 1e3 / first["batches"] for c, us in busy_by_cat.items()},
                    "idle_share_traced": max(0.0, 1 - busy_us / 1e6 / first["seconds"]),
                    "idle_share_vs_untraced_step": max(0.0, 1 - busy_us / 1e6 / first["batches"] / step_s),
                    "trace_events": len(trace["traceEvents"]),
                },
                "pass_losses": pass_losses,
            }
        )

    # 3. the checkpoint, reloaded on the card: the same outputs as the trained
    # model. Both see the same batches (the reloaded Trainer starts from the
    # trained one's buckets: other padding gives the weight products other
    # shapes), and the per-graph pools' scatters (index_add_) sum in a fixed
    # order, so the outputs can differ only where the checkpoint does
    test_set = dataset(spec["check"], train_source=ckpt)
    trained, reloaded = Recorder(), Recorder()
    t._output_exporters = OutputExporterCollection(trained)
    t2 = Trainer(model_cls, dataset_test=test_set, pretrained_model=ckpt, output_exporters=[reloaded])
    if hasattr(t, "_bs_caps"):
        t2._bs_caps = dict(t._bs_caps)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with t._output_exporters:
            t._eval(test_set, t.epoch_saved_model, "testing", spec["check_batch_size"])
        t2.test(batch_size=spec["check_batch_size"])
    finally:
        torch.use_deterministic_algorithms(False)
    got, want_out = reloaded.passes[0]["outputs"], trained.passes[0]["outputs"]
    if got.keys() != want_out.keys():
        msg = f"{name}: the reloaded checkpoint's outputs name other entries"
        raise AssertionError(msg)
    close("checkpoint outputs", torch.tensor([got[k] for k in got]), torch.tensor([want_out[k] for k in got]), CKPT_TOL)
    out["checkpoint"] = {"tolerance": CKPT_TOL, "entries": len(got), "epoch_saved_model": t.epoch_saved_model, "device": str(t2.device)}
    out["max_abs_err"] = errs
    tmp.cleanup()
    return {"launches": launches, "launches_by_form": forms, "summary": out}


def atomic_entries(make, edge_dim, sizes) -> list:
    """The Trainer phases' atomic-resolution entries: one per (nodes, seed),
    named apart and with alternating targets."""
    entries = []
    for i, (n, seed) in enumerate(sizes):
        entry = make(n, 38, edge_dim, seed=seed)
        entry["entry_name"], entry["y"] = f"n{n}_s{seed}", float(i % 2)
        entries.append(entry)
    return entries


def trainer_atomic_phases(torch, counters, record, path_step_s) -> tuple:
    """The atomic-resolution models through ``Trainer.train`` (phases 43-46):
    trainer_bcsr, trainer_clustered_bcsr and trainer_blocked timed (one graph
    a batch, the grow-only buckets growing over entries of 60k-100k nodes),
    then SGATBlockSparse and FoutNetBlockSparse card against CPU. Returns the
    Trainers' final buckets and the entries, for the padded-kernel checks."""
    from deeprank2_tpu_torch.neuralnets.gnn.clustered_blocksparse import FoutNetBlockSparse, GINetClusteredBlockSparse, SGATBlockSparse
    from deeprank2_tpu_torch.neuralnets.gnn.ginet_blocksparse import GINetBlockSparse
    from deeprank2_tpu_torch.neuralnets.gnn.vanilla_gnn import VanillaNetworkBlocked
    from deeprank2_tpu_torch.ops.batch import blocked_requirements, blocksparse_requirements, clustered_blocksparse_requirements
    from deeprank2_tpu_torch.ops.synthetic import clustered_entry, geometric_entry

    sizes, check_sizes = TRAINER_ATOMIC["sizes"], TRAINER_ATOMIC["check_sizes"]
    geo = atomic_entries(geometric_entry, BCSR["edge_dim"], sizes)
    geo_check = atomic_entries(geometric_entry, BCSR["edge_dim"], check_sizes)
    clu = atomic_entries(clustered_entry, CLUSTERED_BCSR["edge_dim"], sizes)
    clu_check = atomic_entries(clustered_entry, CLUSTERED_BCSR["edge_dim"], check_sizes)
    k5, k5b = "bcsr_spmm_kernel[int8/float32]", "bcsr_spmm_kernel[bfloat16/float32]"
    # the card-against-CPU epoch is one step, both check entries in one
    # batch: every step after Adam's first moves a parameter by about lr times
    # the sign of its gradient, so a gradient that rounding alone makes
    # nonzero moves the two sides apart by lr, more than the bare phase's
    # gradient tolerance allows
    common = {"batch_size": 1, "check_batch_size": len(TRAINER_ATOMIC["check_sizes"]), "epochs": TRAINER_ATOMIC["epochs"], "eval_forms": {}}
    specs = [
        {
            **common,
            "name": "trainer_bcsr",
            "model": GINetBlockSparse,
            "clustered": False,
            "entries": geo,
            "check": geo_check,
            "step": {"bcsr_spmm_kernel": 4},
            "eval": {"bcsr_spmm_kernel": 2},
            "step_forms": {k5: 4},
            "eval_forms": {k5: 2},
            "grad_tol": CLUSTERED_GRAD_TOL,
            "bare_step_s": path_step_s["bcsr"],
            "buckets": expected_buckets(dict(zip(("tiles", "blocks"), blocksparse_requirements([e]))) for e in geo),
        },
        {
            **common,
            "name": "trainer_clustered_bcsr",
            "model": GINetClusteredBlockSparse,
            "clustered": True,
            "entries": clu,
            "check": clu_check,
            "step": {"bcsr_spmm_kernel": 4, "slot_fwd_kernel": 1, "slot_bwd_kernel": 1},
            "eval": {"bcsr_spmm_kernel": 2, "slot_fwd_kernel": 1},
            "step_forms": {k5: 4},
            "eval_forms": {k5: 2},
            "grad_tol": CLUSTERED_GRAD_TOL,
            "bare_step_s": path_step_s["clustered_bcsr"],
            "buckets": expected_buckets(clustered_blocksparse_requirements([e], slot8=True) for e in clu),
        },
        {
            **common,
            "name": "trainer_blocked",
            "model": VanillaNetworkBlocked,
            "clustered": False,
            "entries": geo,
            "check": geo_check,
            "step": {"blocked_fwd_kernel": 2, "blocked_bwd_kernel": 2},
            "eval": {"blocked_fwd_kernel": 2},
            "step_forms": {"blocked_fwd_kernel[float32]": 2, "blocked_bwd_kernel[float32]": 2},
            "eval_forms": {"blocked_fwd_kernel[float32]": 2},
            "grad_tol": CLUSTERED_GRAD_TOL,
            "bare_step_s": path_step_s["blocked"],
            "buckets": expected_buckets(dict(zip(("be_tiles", "be_slabs"), blocked_requirements([e]))) for e in geo),
        },
        {
            **common,
            "name": "trainer_sgat_bcsr",
            "model": SGATBlockSparse,
            "clustered": True,
            "entries": [],
            "epochs": 0,
            "check": clu_check,
            "step": {"bcsr_spmm_kernel": 4, "slot_fwd_kernel": 1, "slot_bwd_kernel": 1},
            "eval": {"bcsr_spmm_kernel": 2, "slot_fwd_kernel": 1},
            "step_forms": {k5b: 4},
            "eval_forms": {k5b: 2},
            "grad_tol": SGAT_FOUTNET_GRAD_TOL,
        },
        {
            **common,
            "name": "trainer_foutnet_bcsr",
            "model": FoutNetBlockSparse,
            "clustered": True,
            "entries": [],
            "epochs": 0,
            "check": clu_check,
            "step": {"bcsr_spmm_kernel": 4, "slot_fwd_kernel": 1, "slot_bwd_kernel": 1},
            "eval": {"bcsr_spmm_kernel": 2, "slot_fwd_kernel": 1},
            "step_forms": {k5: 4},
            "eval_forms": {k5: 2},
            "grad_tol": SGAT_FOUTNET_GRAD_TOL,
        },
    ]
    caps = {}
    for spec in specs:
        run = trainer_phase(torch, counters, spec)
        record(spec["name"], run)
        caps[spec["name"]] = run["summary"].get("buckets")
        emit({"phase": spec["name"], "card": card_line(), "model": f"{spec['model'].__name__} through Trainer.train", **run["summary"]})
        del run
    return caps, geo, clu


def trainer_dense_family_phase(torch, counters, record) -> None:
    """GINetClusteredDense, FoutNetDense and SGATDense (weighted) through
    ``Trainer.train`` on the clustered PPI entries, batches of 256 (phase
    48): batched products only, so every kernel counter stays 0."""
    from deeprank2_tpu_torch.neuralnets.gnn.foutnet import FoutNetDense
    from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetClusteredDense
    from deeprank2_tpu_torch.neuralnets.gnn.sgat import SGATDense
    from deeprank2_tpu_torch.ops.synthetic import ppi_clustered_entries

    entries = ppi_clustered_entries(DENSE_FAMILY["entries"], CLUSTERED["nodes"], CLUSTERED["feat"], seed=CLUSTERED["seed"])
    for i, e in enumerate(entries):
        e["y"] = float(i % 2)
    for model, grad_tol in ((GINetClusteredDense, CLUSTERED_GRAD_TOL), (FoutNetDense, SGAT_FOUTNET_GRAD_TOL), (SGATDense, SGAT_FOUTNET_GRAD_TOL)):
        spec = {
            "name": f"trainer_{model.__name__}",
            "model": model,
            "clustered": True,
            "entries": entries,
            "check": entries[: DENSE_FAMILY["batch_size"]],  # one step, as in trainer_phase's other callers
            "batch_size": DENSE_FAMILY["batch_size"],
            "check_batch_size": DENSE_FAMILY["batch_size"],
            "epochs": DENSE_FAMILY["epochs"],
            "step": {},
            "eval": {},
            "step_forms": {},
            "eval_forms": {},
            "grad_tol": grad_tol,
        }
        run = trainer_phase(torch, counters, spec)
        record(spec["name"], run)
        emit({"phase": "trainer_dense_family", "card": card_line(), "model": f"{model.__name__}(38, 2, 1) through Trainer.train", **run["summary"]})


def padded_kernels_phase(torch, checks, caps, geo, clu, dev) -> dict:
    """K5 (int8 and bf16 blocks), K3, K4, K6f and K6b against their plain
    versions at the padded shapes of the Trainer phases (phase 47): the
    smallest entry of each phase (60k nodes) collated again at the buckets
    its Trainer ended with, as the Trainer's shuffled epochs collated it, so
    the padding tiles, blocks, slabs and member slots are there (sGAT's bf16
    blocks at the clustered phase's buckets)."""
    from deeprank2_tpu_torch.ops import block_sparse as bs
    from deeprank2_tpu_torch.ops import blocked_edges as be
    from deeprank2_tpu_torch.ops import slotpool as sp
    from deeprank2_tpu_torch.ops import vanilla as vn
    from deeprank2_tpu_torch.ops.batch import (
        blocked_requirements,
        blocksparse_requirements,
        clustered_blocksparse_requirements,
        collate_graphs_blocked,
        collate_graphs_blocksparse,
        collate_graphs_blocksparse_clustered,
    )

    n_checks = len(checks.rows)
    c = caps["trainer_bcsr"]
    b_batch, _ = collate_graphs_blocksparse(geo[:1], pad_tiles=c["tiles"], pad_blocks=c["blocks"], device=dev)
    c = caps["trainer_clustered_bcsr"]
    kw = {
        "pad_tiles": c["tiles"],
        "pad_blocks": c["blocks"],
        "pad_pooled_tiles": c["pooled_tiles"],
        "pad_pooled_blocks": c["pooled_blocks"],
        "pad_c1": c["c1"],
        "pad_members0": c["members0_s"],
        "pad_members1": c["members1_s"],
        "pad_members0s": c["members0s_s"],
        "slot8": True,
        "device": dev,
    }
    cb_batch, _ = collate_graphs_blocksparse_clustered(clu[:1], **kw)
    sw_batch, _ = collate_graphs_blocksparse_clustered(clu[:1], with_edge_weights=True, **kw)
    c = caps["trainer_blocked"]
    bl_batch, _ = collate_graphs_blocked(geo[:1], pad_tiles=c["be_tiles"], pad_slabs=c["be_slabs"], device=dev)

    shapes = {}
    for what, st in (("bcsr", b_batch.structure), ("clustered_bcsr", cb_batch.structure), ("clustered_bcsr_pooled", cb_batch.structure_p), ("sgat_bcsr", sw_batch.structure)):
        shapes[what] = {"tiles": st.num_tiles, "blocks_stored": st.num_blocks, "blocks_nonzero": st.tile_blocks.numel()}
    shapes["bcsr"]["tiles_required"] = blocksparse_requirements(geo[:1])[0]
    shapes["clustered_bcsr"]["tiles_required"] = clustered_blocksparse_requirements(clu[:1], slot8=True)["tiles"]
    shapes["blocked"] = {"tiles": bl_batch.structure.num_node_tiles, "slabs": bl_batch.structure.num_slabs, "tiles_required": blocked_requirements(geo[:1])[0]}
    shapes["blocked"]["slabs_required"] = blocked_requirements(geo[:1])[1]
    # the full structures hold padding tiles, the BCSR ones padding blocks
    for what, s in shapes.items():
        if s["tiles"] <= s.get("tiles_required", 0) or s.get("blocks_stored", 1) <= s.get("blocks_nonzero", 0) or s.get("slabs", 1) <= s.get("slabs_required", 0):
            msg = f"padded_kernels_vs_plain: the {what} structure holds no padding: {s}"
            raise AssertionError(msg)
    for cd in (None, torch.bfloat16):
        check_bcsr_kernel(
            torch,
            bs,
            checks,
            [
                ("trainer_bcsr padded", b_batch.structure, (32, 64)),
                ("trainer_clustered_bcsr padded full", cb_batch.structure, (32,)),
                ("trainer_clustered_bcsr padded pooled", cb_batch.structure_p, (64,)),
                ("trainer_sgat_bcsr padded full (bf16 blocks)", sw_batch.structure, (16,)),
                ("trainer_sgat_bcsr padded pooled (bf16 blocks)", sw_batch.structure_p, (32,)),
            ],
            dev,
            compute_dtype=cd,
        )
    check_bcsr_order(torch, bs, checks, [("trainer_bcsr padded", b_batch.structure, (32,)), ("trainer_clustered_bcsr padded pooled", cb_batch.structure_p, (64,))], dev)
    mask_row = cb_batch.node_mask.float().reshape(1, -1)
    check_slot_kernels(torch, sp, checks, [(f"trainer_clustered_bcsr padded F=32 V={mask_row.shape[1]}", 32, mask_row.shape[1], mask_row, (8,))], dev)
    check_blocked_kernels(torch, be, vn, checks, [("trainer_blocked padded", bl_batch.structure, (32, 12))], dev)
    tolerance = {
        "bcsr_spmm_kernel": TOL,
        "bcsr_spmm_kernel bf16 blocks": {"rtol": 1e-5, "atol": f"max(1e-5, {DW_TOL} * max |A| |x|)"},
        "bcsr_spmm_kernel order loop": EXACT,
        "slot_fwd_kernel": EXACT,
        "slot_bwd_kernel": EXACT,
        "blocked out, dxr, dxc": TOL,
        "blocked order loop": EXACT,
        "dw_e": {"rtol": 1e-5, "atol": f"{DW_TOL} * max sum_e |e_attr| |g[row]|"},
    }
    return {"phase": "padded_kernels_vs_plain", "buckets": caps, "padded_shapes": shapes, "tolerance": tolerance, "checks": checks.rows[n_checks:]}


def ginet_dense_batched_phase(torch, counters, dev) -> dict:
    """GINetDense on a batch whose N exceeds K1's shared memory (phase 49):
    its batched branch, one step on the card against the same step on the
    CPU (the CPU batch without the flat route's operands, so that the CPU
    takes the same branch) at the dense step's tolerances, with K1 and K2,
    and every other kernel, at 0."""
    import dataclasses

    from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetDense
    from deeprank2_tpu_torch.ops import diag_spmm as ds
    from deeprank2_tpu_torch.ops.batch import collate_graphs_dense
    from deeprank2_tpu_torch.ops.losses import CrossEntropyLoss
    from deeprank2_tpu_torch.ops.synthetic import synthetic_entries

    n = ds.max_nodes(torch.int8, dev) + 32
    entries = synthetic_entries(DENSE_BATCHED["graphs"], n, BENCH["feat"], BENCH["edge_dim"], seed=BENCH["seed"])
    batch, _ = collate_graphs_dense(entries, pad_nodes=n, device=dev)
    model = GINetDense(BENCH["feat"], 2, BENCH["edge_dim"], device=dev, generator=torch.Generator().manual_seed(0))

    def cpu_factory():
        return GINetDense(BENCH["feat"], 2, BENCH["edge_dim"], device="cpu")

    # the CPU's flat route has no shared-memory bound: its batch holds the
    # adjacency as adj, without the flat route's operands (the collate's
    # with_diag_operands=False), so that it takes the batched branch
    full_cpu = batch.to("cpu")
    no_operands = dataclasses.replace(full_cpu, adj=full_cpu.adj_i8.to(torch.bfloat16), adj_i8=torch.zeros((0, 0, 0), dtype=torch.int8), x_t=torch.zeros((0, 0)))
    sync(torch, dev)
    counters.reset()
    step, cpu_model, _ = card_vs_cpu_step(torch, model, batch, CrossEntropyLoss(), cpu_factory, STEP_TOL, STEP_TOL, cpu_batch=no_operands)
    sync(torch, dev)
    launches = counters.read()
    if launches != want_launches():
        msg = f"GINetDense beyond K1's max_nodes launched {launches}; its batched branch launches no kernel"
        raise AssertionError(msg)
    with torch.no_grad():
        flat_cpu = cpu_model(full_cpu)
        card = model(batch).cpu()
    return {
        "phase": "ginet_dense_batched",
        "model": "GINetDense(38, 2, 6)",
        "batch": {"graphs": DENSE_BATCHED["graphs"], "nodes": n, "k1_max_nodes_int8_f32": n - 32, "adj_i8": list(batch.adj_i8.shape)},
        "tolerance": STEP_TOL,
        "launches": launches,
        **step,
        "logits_vs_cpu_flat_route": (card - flat_cpu).abs().max().item(),
    }


@contextlib.contextmanager
def tf32_default(torch):
    """cuDNN's TF32 switch at PyTorch's default (on) inside the block, turned
    off again after (this script turns it off for the kernels' checks): the
    CNNs must sum their convolutions in float32 whatever it says."""
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = False


def grid_batch(torch, n, seed, dev, shell=0):
    """``n`` grids of the reference grid protocol (CNN: 33 features, a
    35x30x30 box; ``grid_arrays``' recipe), the outer ``shell`` voxels
    zeroed where given, collated on ``dev``."""
    from deeprank2_tpu_torch.ops.batch import collate_grids
    from deeprank2_tpu_torch.ops.synthetic import grid_arrays, grid_entries, zero_shell

    x, y = grid_arrays(n, CNN["features"], CNN["box"], seed=seed)
    if shell:
        x = zero_shell(x, shell)
    return collate_grids(grid_entries(x, y), device=dev)[0]


def cnn_loss(model_cls):
    """The CNN's loss of its outputs: CrossEntropy on the classifier's
    logits, MSE on the regressor's single output."""
    from deeprank2_tpu_torch.ops.losses import CrossEntropyLoss, MSELoss

    if model_cls.__name__ == "CnnClassification":
        ce = CrossEntropyLoss()
        return lambda out, b: ce(out, b.y, b.y_mask)
    mse = MSELoss()
    return lambda out, b: mse(out.reshape(-1), b.y, b.y_mask)


def gate_row(row: dict) -> dict:
    """A float64 gate row for the JSON line (without its tensors)."""
    return {k: v for k, v in row.items() if k != "f64"}


def cnn_card_vs_cpu(torch, fg, counters, model_cls, batch, dev, positive_bias=False) -> tuple:
    """One step of ``model_cls`` (weights from a seeded generator; with
    ``positive_bias`` the conv biases made positive, so that a zero shell's
    windows tie at a positive value) on the card and on the CPU from the
    same weights and batch, with cuDNN's TF32 switch at its default: logits
    and loss card against CPU at CROSS_TOL; every gradient, the card's and
    the CPU's, against the network in float64 at the per-entry gate
    (``tools/f64_gate.py:hold_cnn``, its float64 on the card), relu and
    max-pool winner flips held to their band; the CPU's gradients against
    float64 reported beside them (its own f32 route, not the one under
    test); no kernel of K1-K9. Returns the card's model and the summary."""
    f, box = CNN["features"], CNN["box"]
    model = model_cls(f, box, device=dev, generator=torch.Generator().manual_seed(0))
    if positive_bias:
        with torch.no_grad():
            for conv in (model.convlayer_000, model.convlayer_002):
                conv.bias.copy_(conv.bias.abs() + 0.05)
    cpu = model_cls(f, box, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    loss_of = cnn_loss(model_cls)
    sides = {}
    with tf32_default(torch):
        sync(torch, dev)
        counters.reset()
        for side, m, b in (("card", model, batch), ("cpu", cpu, batch.to("cpu"))):
            t0 = time.perf_counter()
            out = m(b)
            loss = loss_of(out, b)
            loss.backward()
            sync(torch, dev)
            sides[side] = {"logits": out.detach().cpu(), "loss": loss.detach().cpu(), "grads": {k: p.grad for k, p in m.named_parameters()}, "s": time.perf_counter() - t0}
            sides[side]["decisions"] = fg.cnn_decisions(m, b.x)
        sync(torch, dev)
        launches = counters.read()
        if launches != want_launches():
            msg = f"{model_cls.__name__} launched {launches}; it runs no kernel of K1-K9"
            raise AssertionError(msg)
        errs = {}
        for what in ("logits", "loss"):
            got, want = sides["card"][what], sides["cpu"][what]
            torch.testing.assert_close(got, want, **CROSS_TOL, msg=lambda m, what=what: f"{model_cls.__name__} card vs CPU {what}: {m}")
            errs[what] = (got - want).abs().max().item()
        for k, g in sides["card"]["grads"].items():
            errs[f"grad {k}"] = (g.cpu() - sides["cpu"]["grads"][k]).abs().max().item()
        rows = {}
        t0 = time.perf_counter()
        for side in ("card", "cpu"):
            row = fg.hold_cnn(side, sides[side]["grads"], model.state_dict(), batch.x, lambda lg: loss_of(lg, batch), sides[side]["decisions"], raise_on_fail=side == "card")
            for what in ("logits", "loss"):
                torch.testing.assert_close(sides[side][what].double(), row["f64"][what].cpu(), **CROSS_TOL, msg=lambda m, side=side, what=what: f"{side} {what} vs float64: {m}")
            rows[side] = gate_row(row)
        oracle_s = time.perf_counter() - t0
    model.zero_grad(set_to_none=True)
    return model, {
        "model": f"{model_cls.__name__}({f}, {box})",
        "tf32_cudnn_during_check": True,
        "tolerance": {"logits_and_loss_card_vs_cpu": CROSS_TOL, "grads": f"against float64, atol max({fg.ATOL}, {fg.C} 2^-24 S), rtol {fg.RTOL}"},
        "loss": sides["card"]["loss"].item(),
        "max_abs_err_card_vs_cpu": errs,
        "f64_gate": rows,
        "launches": launches,
        "step_s": {"card": sides["card"]["s"], "cpu": sides["cpu"]["s"], "float64_oracles": oracle_s},
    }


def cnn_bound(batch_size, peak) -> dict:
    """The CNN train step's least time on the card: its HBM floor (x read by
    conv1's forward and weight gradient; h1, its pool and h2 written, read
    by the next layer and once more by the backward: 2x + 3(h1 + h1p + h2),
    tests/perf/cnn_perf.py:cnn_hbm_floor_bytes) against its f32 operations
    (conv1 forward and weight gradient; conv2 forward, data and weight
    gradients; the FC layers' three products each)."""
    f, (w, h, d) = CNN["features"], CNN["box"]
    c1 = (w - 1, h - 1, d - 1)
    p1 = tuple(c // 2 for c in c1)
    c2 = tuple(c - 1 for c in p1)
    p2 = tuple(c // 2 for c in c2)
    vol = math.prod
    x_b, h1_b, h1p_b, h2_b = (batch_size * ch * vol(shape) * 4 for ch, shape in ((f, (w, h, d)), (4, c1), (4, p1), (5, c2)))
    flat = 5 * vol(p2)
    flop = 2 * 2 * batch_size * 4 * vol(c1) * f * 8 + 3 * 2 * batch_size * 5 * vol(c2) * 4 * 8 + 3 * 2 * batch_size * (flat * 84 + 84 * 2)
    return {**bound(2 * x_b + 3 * (h1_b + h1p_b + h2_b), 0, flop, peak), "flop": flop, "tensor_mb": {"x": x_b / 1e6, "h1": h1_b / 1e6, "h1p": h1p_b / 1e6, "h2": h2_b / 1e6}}


def cnn_conv_calls(torch, model, batch) -> list:
    """Each convolution of the CNN's train step apart, at the step's shapes:
    its forward, its weight gradient (with the bias's, one call as autograd
    makes it) and, for conv2 only, its data gradient (conv1's input, the
    grids, wants none), without TF32 as the model runs them: CUDA-event ms
    with the L2 flushed, the profiler's device ms and the kernels' names."""
    from deeprank2_tpu_torch.neuralnets.nn import ieee_fp32
    from deeprank2_tpu_torch.tools.timing import Timer

    f, timer = torch.nn.functional, Timer()
    backward = torch.ops.aten.convolution_backward
    with torch.no_grad(), ieee_fp32():
        h1p = f.max_pool3d(torch.relu(f.conv3d(batch.x, model.convlayer_000.weight, model.convlayer_000.bias)), 2, 2)
        rows = []
        for name, x, data_gradient in (("convlayer_000", batch.x, False), ("convlayer_002", h1p, True)):
            layer = getattr(model, name)
            w, b = layer.weight, layer.bias
            g = torch.randn_like(f.conv3d(x, w, b))
            calls = {
                "forward": lambda x=x, w=w, b=b: f.conv3d(x, w, b),
                "weight_gradient": lambda x=x, w=w, g=g: backward(g, x, w, [w.shape[0]], [1] * 3, [0] * 3, [1] * 3, False, [0] * 3, 1, [False, True, True]),
            }
            if data_gradient:
                calls["data_gradient"] = lambda x=x, w=w, g=g: backward(g, x, w, None, [1] * 3, [0] * 3, [1] * 3, False, [0] * 3, 1, [True, False, False])
            for what, fn in calls.items():
                device_ms = timer.launch_ms(fn, {"call": ""})["call"]
                names = sorted({k for k, _ in timer.kernels(fn, reps=1)} - timer.flush_keys)
                rows.append({"conv": name, "call": what, "ms": timer.ms(fn), "device_ms": device_ms, "kernels": [k[:90] for k in names]})
    return rows


def grid_phases(torch, counters, card, peak, dev) -> None:
    """Phases 50-53: the grid path (see the module docstring)."""
    from deeprank2_tpu_torch.neuralnets.cnn.model3d import CnnClassification, CnnRegression
    from deeprank2_tpu_torch.ops.optim import Adam
    from deeprank2_tpu_torch.ops.synthetic import grid_arrays, grid_entries
    from deeprank2_tpu_torch.tools import f64_gate as fg

    # 50. cnn: the step against the CPU, then the timed and profiled steps
    t_phase = time.perf_counter()
    batch = grid_batch(torch, CNN["batch"], CNN["seed"], dev)
    model, step = cnn_card_vs_cpu(torch, fg, counters, CnnClassification, batch, dev)
    loss_of = cnn_loss(CnnClassification)
    with tf32_default(torch):
        opt = Adam(model.parameters(), lr=1e-3, weight_decay=1e-5)
        run = run_main_path(torch, counters, model, batch, lambda out, y, m: loss_of(out, batch), opt, dev, want_launches(), CNN["steps"], warm=CNN["warm"])
        train_step = run.pop("train_step")
        prof = profile_steps(torch, train_step, run["step_s"])
    if prof["host_syncs_per_step"]:
        msg = f"cnn: {prof['host_syncs_per_step']} host syncs a step: {prof['host_sync_sites']}"
        raise AssertionError(msg)
    floor = cnn_bound(CNN["batch"], peak)
    emit(
        {
            "phase": "cnn",
            "card": card,
            "batch": {"grids": CNN["batch"], "features": CNN["features"], "box": list(CNN["box"]), "seed": CNN["seed"], "x_mb": batch.x.numel() * 4 / 1e6},
            "card_vs_cpu": step,
            **run,
            "step_ms": run["step_s"] * 1e3,
            "grids_per_s": CNN["batch"] / run["step_s"],
            "bound": floor,
            "step_over_bound": run["step_s"] * 1e3 / floor["bound_ms"],
            "profile": prof,
            "conv_calls": cnn_conv_calls(torch, model, batch),
            "seconds": time.perf_counter() - t_phase,
        }
    )
    bare_step_s = run["step_s"]
    del model, opt, train_step

    # 51. cnn_regression: one step against the CPU, with MSE
    t_phase = time.perf_counter()
    _, step = cnn_card_vs_cpu(torch, fg, counters, CnnRegression, batch, dev)
    emit({"phase": "cnn_regression", "card": card, "batch": {"grids": CNN["batch"], "features": CNN["features"], "box": list(CNN["box"])}, **step, "seconds": time.perf_counter() - t_phase})
    del batch

    # 52. cnn_ties: both CNNs on zero-shell grids, whose pooling windows tie
    t_phase = time.perf_counter()
    shell = grid_batch(torch, CNN_TIES["grids"], CNN["seed"], dev, shell=CNN_TIES["shell"])
    rows = {}
    for cls in (CnnClassification, CnnRegression):
        model, step = cnn_card_vs_cpu(torch, fg, counters, cls, shell, dev, positive_bias=True)
        with torch.no_grad():
            h1 = torch.relu(torch.nn.functional.conv3d(shell.x.double(), model.convlayer_000.weight.double(), model.convlayer_000.bias.double()))
        n, c, *dims = h1.shape
        cut = h1[:, :, : dims[0] // 2 * 2, : dims[1] // 2 * 2, : dims[2] // 2 * 2]
        windows = cut.reshape(n, c, dims[0] // 2, 2, dims[1] // 2, 2, dims[2] // 2, 2).permute(0, 1, 2, 4, 6, 3, 5, 7).reshape(-1, 8)
        tied = int(((windows == windows.max(dim=1, keepdim=True).values).sum(dim=1) > 1).sum())
        if tied == 0:
            msg = f"cnn_ties: no tied pooling window in {cls.__name__}'s first pool"
            raise AssertionError(msg)
        rows[cls.__name__] = {**step, "pool1_windows": windows.shape[0], "pool1_tied_windows_float64": tied}
        del model, h1, cut, windows
    emit({"phase": "cnn_ties", "card": card, "grids": CNN_TIES["grids"], "zero_shell_voxels": CNN_TIES["shell"], **rows, "seconds": time.perf_counter() - t_phase})
    del shell

    # 53. trainer_cnn: CnnClassification through Trainer.train on an
    # in-memory GridDataset
    t_phase = time.perf_counter()
    x, y = grid_arrays(TRAINER_CNN["entries"], CNN["features"], CNN["box"], seed=CNN["seed"])
    entries = grid_entries(x, y)

    def grad_gate(initial, trainer, grads):
        # the check epoch's one step: its batch (classes mapped as the
        # Trainer maps them) and the weights it started from
        cpu_batch, _ = trainer._collate(entries[: TRAINER_CNN["batch_size"]], pad_graphs=TRAINER_CNN["batch_size"])
        b = cpu_batch.to(dev)
        loss_of = cnn_loss(CnnClassification)
        rows = {}
        for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
            m = CnnClassification(CNN["features"], CNN["box"], device=device)
            m.load_state_dict(initial)
            decisions = fg.cnn_decisions(m, b.x.to(device))
            rows[side] = gate_row(fg.hold_cnn(side, grads[side], initial, b.x, lambda lg: loss_of(lg, b), decisions, raise_on_fail=side == "card"))
        return rows

    with tf32_default(torch):
        run = trainer_phase(
            torch,
            counters,
            {
                "name": "trainer_cnn",
                "model": CnnClassification,
                "dataset": in_memory_grid_dataset,
                "clustered": False,
                "entries": entries,
                "check": entries[: TRAINER_CNN["batch_size"]],
                "batch_size": TRAINER_CNN["batch_size"],
                "check_batch_size": TRAINER_CNN["batch_size"],
                "epochs": TRAINER_CNN["epochs"],
                "step": {},
                "eval": {},
                "step_forms": {},
                "eval_forms": {},
                "grad_gate": grad_gate,
                "bare_step_s": bare_step_s,
            },
        )
    emit({"phase": "trainer_cnn", "card": card, "model": f"CnnClassification({CNN['features']}, {CNN['box']}) through Trainer.train", **run["summary"], "seconds": time.perf_counter() - t_phase})


def alignment_phase(torch, counters, card, dev) -> dict:
    """Phase 54: AlignmentGNN's forward and backward on the graph of the
    bench entries (see the module docstring)."""
    import numpy as np

    from deeprank2_tpu_torch.neuralnets.gnn.alignmentnet import AlignmentGNN
    from deeprank2_tpu_torch.ops.synthetic import synthetic_entries
    from deeprank2_tpu_torch.tools import f64_gate as fg

    t_phase = time.perf_counter()
    a = ALIGNMENT
    entries = synthetic_entries(BENCH["num_graphs"], BENCH["nodes"], BENCH["feat"], BENCH["edge_dim"], seed=BENCH["seed"])
    offsets = np.cumsum([0] + [e["x"].shape[0] for e in entries[:-1]])
    # the undirected pairs in both directions (the bench's directed edges):
    # each node sums the messages of its every neighbour
    und = np.concatenate([e["edge_index"] + o for e, o in zip(entries, offsets)])
    edges = torch.from_numpy(np.concatenate([und, und[:, ::-1]]).T.copy())
    edge_attr = torch.from_numpy(np.tile(np.concatenate([e["edge_attr"] for e in entries]), (2, 1)))
    node_attr = torch.from_numpy(np.concatenate([e["x"] for e in entries]))
    v = node_attr.shape[0]
    rng = np.random.default_rng(a["seed"])
    g_out = torch.from_numpy(rng.normal(size=(v, a["output"])).astype(np.float32))
    g_att = torch.from_numpy(rng.normal(size=(v, 1)).astype(np.float32))
    widths = (BENCH["edge_dim"], BENCH["feat"], a["output"], a["hidden"], a["message"], a["mlp"], a["layers"], a["edge_projection"])
    model = AlignmentGNN(*widths, device=dev, generator=torch.Generator().manual_seed(0))

    def make(device, dtype):
        m = AlignmentGNN(*widths, device=device).to(dtype)
        m.load_state_dict({k: t.to(device, dtype) for k, t in model.state_dict().items()})
        return m

    def pass_on(m, device, dtype):
        args = (edges.to(device), edge_attr.to(device, dtype), node_attr.to(device, dtype))
        m.zero_grad(set_to_none=True)
        out, att = m(*args)
        ((out * g_out.to(device, dtype)).sum() + (att * g_att.to(device, dtype)).sum()).backward()
        return out.detach(), att.detach(), {k: p.grad.detach() for k, p in m.named_parameters()}

    sync(torch, dev)
    counters.reset()
    card_out, card_att, card_grads = pass_on(model, dev, torch.float32)
    sync(torch, dev)
    launches = counters.read()
    if launches != want_launches():
        msg = f"AlignmentGNN launched {launches}; it runs no kernel of K1-K9"
        raise AssertionError(msg)
    t0 = time.perf_counter()
    cpu_out, cpu_att, cpu_grads = pass_on(make("cpu", torch.float32), "cpu", torch.float32)
    cpu_s = time.perf_counter() - t0
    f64 = make(dev, torch.float64)
    result = dict(zip(("out", "att", "grads"), pass_on(f64, dev, torch.float64)))
    scales = fg.alignment_sums(f64, edges.to(dev), edge_attr.to(dev), node_attr.to(dev), g_out.to(dev), g_att.to(dev))
    errs = {}
    for what, got, cpu_val, want in (("outputs", card_out, cpu_out, result["out"]), ("attention", card_att, cpu_att, result["att"])):
        torch.testing.assert_close(got.cpu(), cpu_val, **CROSS_TOL, msg=lambda m, what=what: f"AlignmentGNN card vs CPU {what}: {m}")
        torch.testing.assert_close(got.double(), want, **CROSS_TOL, msg=lambda m, what=what: f"AlignmentGNN card vs float64 {what}: {m}")
        errs[what] = (got.cpu() - cpu_val).abs().max().item()
    for k in card_grads:
        errs[f"grad {k}"] = (card_grads[k].cpu() - cpu_grads[k]).abs().max().item()
    rows = {side: fg.hold(side, {k: g.to(dev) for k, g in grads.items()}, result["grads"], scales) for side, grads in (("card", card_grads), ("cpu", cpu_grads))}
    if not rows["card"]["passed"]:  # the CPU's row is reported beside it
        msg = f"AlignmentGNN card gradients against float64: {rows['card']}"
        raise AssertionError(msg)
    # the card's forward and backward, timed
    times = []
    for _ in range(a["timed"] + 2):
        sync(torch, dev)
        t0 = time.perf_counter()
        pass_on(model, dev, torch.float32)
        sync(torch, dev)
        times.append(time.perf_counter() - t0)
    return {
        "phase": "alignment_gnn",
        "card": card,
        "model": "AlignmentGNN(nmb_edge_attr=6, nmb_node_attr=38, nmb_output_features=2, nmb_hidden_attr=64, message_vector_length=32, nmb_mlp_neurons=64, nmb_gnn_layers=3, nmb_edge_projection=16)",
        "graph": {"nodes": v, "edges": int(edges.shape[1]), "source": f"synthetic_entries({BENCH['num_graphs']}, {BENCH['nodes']}, {BENCH['feat']}, {BENCH['edge_dim']}, seed={BENCH['seed']}), one graph, pairs both ways"},
        "tolerance": {"outputs_and_attention": CROSS_TOL, "grads": f"against float64, atol max({fg.ATOL}, {fg.C} 2^-24 S) (S: tools/f64_gate.py:alignment_sums), rtol {fg.RTOL}"},
        "launches": launches,
        "max_abs_err_card_vs_cpu": errs,
        "f64_gate": rows,
        "forward_backward_ms": [t * 1e3 for t in times[2:]],
        "cpu_forward_backward_s": cpu_s,
        "seconds": time.perf_counter() - t_phase,
    }


def featurize(query, modules, settings, method, augmentations=0) -> tuple:
    """What ``QueryCollection._process_one_query`` does for one query
    (deeprank2_tpu_torch/query.py), short of the HDF5 writes, which need
    h5py: the graph, then its grid and one more grid for each augmentation,
    each rotation drawn from ``random`` as there; with the milliseconds of
    the build, of each feature module in it and of each grid."""
    import importlib
    import random

    from deeprank2_tpu_torch.utils.grid import Augmentation, Grid, random_rotation_axis_angle

    module_ms, wrapped = {}, []
    for name in modules:
        module = importlib.import_module(f"deeprank2_tpu_torch.features.{name}")
        add = module.add_features

        def timed(*args, add=add, name=name, **kwargs):
            t0 = time.perf_counter()
            try:
                return add(*args, **kwargs)
            finally:
                module_ms[name] = (time.perf_counter() - t0) * 1e3

        module.add_features = timed
        wrapped.append((module, add))
    try:
        t0 = time.perf_counter()
        graph = query.build(list(modules))
        build_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for module, add in wrapped:
            module.add_features = add
    grids, grid_ms = [], []
    for k in range(augmentations + 1):
        t0 = time.perf_counter()
        augmentation = None if k == 0 else Augmentation(*random_rotation_axis_angle(random.randrange(100)))
        grid = Grid(graph.id if k == 0 else f"{graph.id}_{k - 1:03d}", list(graph.center), settings)
        graph.map_to_grid(grid, method, augmentation)
        grid_ms.append((time.perf_counter() - t0) * 1e3)
        grids.append(grid)
    times = {"build_ms": build_ms, "module_ms": module_ms, "graph_ms": build_ms - sum(module_ms.values()), "grid_ms": grid_ms}
    return graph, grids, times


def graph_entry(graph, node_features=None, edge_features=None, target="binary") -> dict:
    """The entry that ``GraphDataset(file, node_features=...,
    edge_features=..., target=target).get`` gives for ``graph`` in the file
    ``graph.write_to_hdf5`` writes: the features named (every one by
    default, in the order h5py lists them, alphabetical), each column as the
    file gives it back (it keeps every dtype), stacked as float32."""
    import numpy as np

    def columns(features, names):
        return [np.asarray(features[n]).reshape(-1, 1) if np.asarray(features[n]).ndim == 1 else np.asarray(features[n]) for n in names]

    nodes = sorted(n for n in graph.node_features if n[0] != "_") if node_features is None else list(node_features)
    edges = sorted(n for n in graph.edge_features if n[0] != "_") if edge_features is None else list(edge_features)
    edge_index = np.asarray(graph.edge_index).astype(np.int64)
    node_cols, edge_cols = columns(graph.node_features, nodes), columns(graph.edge_features, edges)
    return {
        "x": np.hstack(node_cols).astype(np.float32) if node_cols else None,
        "edge_index": edge_index,
        "edge_attr": np.hstack(edge_cols).astype(np.float32) if edge_cols else np.zeros((edge_index.shape[0], 0), dtype=np.float32),
        "pos": np.asarray(graph.node_features["_position"]).astype(np.float32),
        "y": float(graph.targets[target]),
        "cluster0": None,
        "cluster1": None,
        "entry_name": graph.id,
    }


def grid_entry(grid, graph, features=None, target="binary") -> dict:
    """The entry that ``GridDataset(file, features=..., target=target).get``
    gives for ``grid`` in the file ``graph.write_as_grid_to_hdf5`` writes:
    the mapped features named (every one not starting with ``_`` by
    default, alphabetical), as float32, and the graph's target."""
    import numpy as np

    names = sorted(n for n in grid.features if n[0] != "_") if features is None else list(features)
    return {"x": np.array([grid.features[n] for n in names], dtype=np.float32), "y": float(graph.targets[target]), "entry_name": grid.id}


def native_vs_plain(path: str) -> dict:
    """Each native host kernel against its plain version on one structure
    (phase 55): the parser on the file, SASA on every atom, the Gaussian
    grid kernel on at most NATIVE_GRID_POINTS of its atoms over the
    protocol's box and over a 30 A one; raises on a disagreement."""
    import numpy as np

    from deeprank2_tpu_torch.io.pdb import parse_pdb, parse_pdb_ref
    from deeprank2_tpu_torch.utils import sasa
    from deeprank2_tpu_torch.utils.grid import Grid, GridSettings

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        return out, (time.perf_counter() - t0) * 1e3

    name = f"{Path(path).parent.name}/{Path(path).stem}"
    native, parse_ms = timed(parse_pdb, path)
    ref, parse_ref_ms = timed(parse_pdb_ref, path)
    # field for field, as tests/utils/test_pdb_native.py:21-29
    fields = ("atom_residue", "elements", "res_numbers", "res_aa_ids", "res_chain", "res_atom_start", "res_atom_count")
    same = (native.num_atoms, native.num_residues, native.chain_ids, list(native.atom_names), list(native.res_icodes)) == (
        ref.num_atoms,
        ref.num_residues,
        ref.chain_ids,
        list(ref.atom_names),
        list(ref.res_icodes),
    )
    same = same and np.allclose(native.positions, ref.positions) and np.allclose(native.occupancies, ref.occupancies)
    if not (same and all(np.array_equal(getattr(native, f), getattr(ref, f)) for f in fields)):
        msg = f"native_host_kernels: the native PDB parser differs from parse_pdb_ref on {name}"
        raise AssertionError(msg)
    radii = sasa.atom_radii(np.asarray(native.elements))
    areas, sasa_ms = timed(sasa.shrake_rupley, native.positions, radii)
    ref_areas, sasa_ref_ms = timed(sasa.shrake_rupley_ref, native.positions, radii)
    sasa_err = float(np.abs(areas - ref_areas).max())
    if not sasa_err <= 1e-10:  # tests/utils/test_sasa_native.py:24
        msg = f"native_host_kernels: SASA differs from shrake_rupley_ref by {sasa_err:.3e} on {name} (atol 1e-10)"
        raise AssertionError(msg)
    points = native.positions[:: -(-native.num_atoms // NATIVE_GRID_POINTS)]
    center = list(native.positions.mean(axis=0))
    grid_rows = {}
    for box, sizes in (("protocol", GRID["sizes"]), ("30A", (30.0, 28.0, 26.0))):
        g = Grid("g", center, GridSettings(list(GRID["points"]), list(sizes)))
        k, grid_ms = timed(g._kernel_gaussian, points)
        k_ref, grid_ref_ms = timed(g._kernel_gaussian_ref, points)
        err = np.abs(k.astype(np.float64) - k_ref)
        # tests/utils/test_grid.py's np.allclose gate; on the 30 A box
        # widened, entry by entry, by the plain version's f32 error
        tol = 1e-5 * np.abs(k_ref) + 1e-8 if box == "protocol" else g._kernel_gaussian_ref_tolerance(points)
        if not ((err <= tol).all() and np.isfinite(k).all()):
            msg = f"native_host_kernels: the Gaussian grid kernel differs from _kernel_gaussian_ref on {name} ({box} box): largest error {err.max():.3e}"
            raise AssertionError(msg)
        grid_rows[box] = {"points": len(points), "grid_points": int(k.shape[1]), "ms": grid_ms, "plain_ms": grid_ref_ms, "max_abs_err": float(err.max()), "max_err_over_tol": float((err / tol).max())}
    return {
        "structure": name,
        "atoms": native.num_atoms,
        "parse_ms": parse_ms,
        "parse_plain_ms": parse_ref_ms,
        "parse_bit_equal": bool(np.array_equal(native.positions, ref.positions) and np.array_equal(native.occupancies, ref.occupancies)),
        "sasa_ms": sasa_ms,
        "sasa_plain_ms": sasa_ref_ms,
        "sasa_max_abs_err": sasa_err,
        "gaussian_grid": grid_rows,
    }


def load_host_libraries() -> None:
    from deeprank2_tpu_torch.ops import _build

    for name in _build.HOST_SOURCES:
        _build.host_library(name)


def native_host_phase(card) -> dict:
    """Phase 55: the native host kernels (see the module docstring). The
    libraries build here; the structures are checked side by side in
    spawned worker processes (the plain SASA loop takes seconds a
    structure), which the pool stops before it returns."""
    import concurrent.futures
    import multiprocessing
    import os

    from deeprank2_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    built_s = _build.build_host()
    paths = [str(p) for p in sorted((DATA / "pdb").glob("*/*.pdb"))]
    workers = min(len(paths), os.cpu_count() or 1)
    # each worker loads the libraries before it times a kernel
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"), initializer=load_host_libraries) as pool:
        rows = list(pool.map(native_vs_plain, paths))
    return {
        "phase": "native_host_kernels",
        "card": card,
        "where": f"the card's machine's host CPU, {workers} worker processes side by side, one structure each at a time",
        "cpu": _build._host().decode(errors="replace").splitlines()[-1],
        "libraries": {n: _build.host_target(n).name for n in _build.HOST_SOURCES},
        "flags": {n: [*_build.GXX_FLAGS, *extra] for n, extra in _build.HOST_SOURCES.items()},
        "build_s": built_s,
        "tolerance": {"parser": "field for field, positions and occupancies np.allclose", "sasa": "atol 1e-10", "gaussian_grid": "np.allclose (rtol 1e-5, atol 1e-8); the 30 A box plus the plain version's f32 distance error"},
        "structures": rows,
        "seconds": time.perf_counter() - t_phase,
    }


def check_featurized(name, graph, grids) -> None:
    """A featurized graph and its grids are what the featurization gives
    on a CPU without the card (FEATURIZED_SIZES), finite, of the protocol's
    shape."""
    import numpy as np

    size = (graph.num_nodes, graph.num_edges)
    if name in FEATURIZED_SIZES and FEATURIZED_SIZES[name] != size:
        msg = f"{name}: (nodes, edges) {size}, expected {FEATURIZED_SIZES[name]}"
        raise AssertionError(msg)
    if not (size[0] > 0 and size[1] > 0) or graph.has_nan():
        msg = f"{name}: an empty or non-finite graph, (nodes, edges) {size}"
        raise AssertionError(msg)
    for grid in grids:
        bad = [k for k, v in grid.features.items() if v.shape != GRID["points"] or not np.isfinite(v).all()]
        if bad or not grid.features:
            msg = f"{name}: grid {grid.id} has channels of another shape or non-finite values: {bad}"
            raise AssertionError(msg)


def featurize_phase(card, phase, protocol, jobs) -> dict:
    """Phases 56-57: each query featurized as ``QueryCollection.process``
    would (:func:`featurize`), one at a time, with its times."""
    import statistics

    from deeprank2_tpu_torch.utils.grid import GridSettings, MapMethod

    t_phase = time.perf_counter()
    settings = GridSettings(list(GRID["points"]), list(GRID["sizes"]))
    rows = []
    for name, query, modules in jobs:
        graph, grids, times = featurize(query, modules, settings, MapMethod.GAUSSIAN)
        check_featurized(name, graph, grids)
        rows.append({"query": name, "nodes": graph.num_nodes, "edges": graph.num_edges, "channels": len(grids[0].features), **times, "ms": times["build_ms"] + sum(times["grid_ms"])})
    per_query = [r["ms"] for r in rows]
    return {
        "phase": phase,
        "card": card,
        "where": "the card's machine's host CPU: one Python process, one query at a time (numpy's BLAS may use its own threads in the grid's matmul)",
        "protocol": protocol,
        "queries": rows,
        "median_ms": statistics.median(per_query),
        "mean_ms": statistics.mean(per_query),
        "median_build_ms": statistics.median(r["build_ms"] for r in rows),
        "median_grid_ms": statistics.median(r["grid_ms"][0] for r in rows),
        "queries_per_s": len(rows) / (sum(per_query) / 1e3),
        "seconds": time.perf_counter() - t_phase,
    }


def featurize_phases(card) -> None:
    """Phases 56-57: the reference featurization protocols."""
    from deeprank2_tpu_torch.molstruct.aminoacid import alanine, phenylalanine
    from deeprank2_tpu_torch.query import ProteinProteinInterfaceQuery, SingleResidueVariantQuery

    ppi, srv = FEATURIZE_PPI, FEATURIZE_SRV
    jobs = [
        (
            f"{pdb}:{'-'.join(chains)}",
            ProteinProteinInterfaceQuery(
                pdb_path=str(DATA / "pdb" / f"{pdb}.pdb"),
                resolution=ppi["resolution"],
                chain_ids=list(chains),
                influence_radius=ppi["cutoff"],
                max_edge_length=ppi["cutoff"],
                targets={"binary": 0},
            ),
            ppi["modules"],
        )
        for pdb, chains in PPI_STRUCTURES
    ]
    emit(featurize_phase(card, "featurize_ppi", {**ppi, "grid": GRID, "map": "GAUSSIAN", "source": "tests/perf/ppi_perf.py:16-17"}, jobs))
    jobs = [
        (
            f"{srv['pdb']}:{srv['chain']}:{res}",
            SingleResidueVariantQuery(
                pdb_path=str(DATA / "pdb" / f"{srv['pdb']}.pdb"),
                resolution="residue",
                chain_ids=srv["chain"],
                variant_residue_number=res,
                insertion_code=None,
                wildtype_amino_acid=alanine,
                variant_amino_acid=phenylalanine,
                targets={"binary": 0},
            ),
            srv["modules"],
        )
        for res in srv["residues"]
    ]
    emit(featurize_phase(card, "featurize_srv", {**srv, "resolution": "residue", "radius": 10.0, "grid": GRID, "map": "GAUSSIAN", "source": "tests/perf/srv_perf.py:1-3, 37-60"}, jobs))


def trainer_featurized_phase(torch, counters, card, dev) -> None:
    """Phase 58: VanillaNetwork and CnnClassification through
    ``Trainer.train`` on the real structures, featurized in memory."""
    import functools
    import random

    from deeprank2_tpu_torch.neuralnets.cnn.model3d import CnnClassification
    from deeprank2_tpu_torch.neuralnets.gnn.vanilla_gnn import VanillaNetwork
    from deeprank2_tpu_torch.query import ProteinProteinInterfaceQuery
    from deeprank2_tpu_torch.tools import f64_gate as fg
    from deeprank2_tpu_torch.utils.grid import GridSettings, MapMethod

    t_phase = time.perf_counter()
    tf = TRAINER_FEATURIZED
    settings = GridSettings(list(GRID["points"]), list(GRID["sizes"]))
    random.seed(tf["seed"])
    graphs, grids, featurize_ms = [], [], []
    for i, (pdb, chains) in enumerate(PPI_STRUCTURES):
        # the PPI tutorial's demo targets: binding affinity 100 + 900 (i mod 3), binary below 500
        query = ProteinProteinInterfaceQuery(
            pdb_path=str(DATA / "pdb" / f"{pdb}.pdb"),
            resolution="residue",
            chain_ids=list(chains),
            influence_radius=tf["radius"],
            max_edge_length=tf["radius"],
            targets={"binary": int(100.0 + 900.0 * (i % 3) <= 500), "BA": 100.0 + 900.0 * (i % 3)},
        )
        graph, graph_grids, times = featurize(query, tf["modules"], settings, MapMethod.GAUSSIAN, tf["augmentations"])
        check_featurized(f"{pdb}:{'-'.join(chains)}:residue", graph, graph_grids)
        graphs.append(graph)
        grids += [(grid, graph) for grid in graph_grids]
        featurize_ms.append(times["build_ms"] + sum(times["grid_ms"]))
    graph_entries = [graph_entry(g, tf["node_features"], tf["edge_features"]) for g in graphs]
    grid_entries = [grid_entry(grid, g) for grid, g in grids]
    channels = sorted(n for n in grids[0][0].features if n[0] != "_")
    emit(
        {
            "phase": "trainer_featurized_data",
            "card": card,
            "graphs": [{"entry": e["entry_name"], "nodes": int(e["x"].shape[0]), "edges": int(e["edge_index"].shape[0]), "y": e["y"]} for e in graph_entries],
            "grids": len(grid_entries),
            "grid_channels": len(channels),
            "featurize_ms": featurize_ms,
            "seconds": time.perf_counter() - t_phase,
        }
    )

    # VanillaNetwork on the COO branch: K7 twice a step (its two convs'
    # forwards; the VJP is a gather) and twice an eval batch
    t_phase = time.perf_counter()
    bs = tf["batch_size"]
    run = trainer_phase(
        torch,
        counters,
        {
            "name": "trainer_featurized_vanilla",
            "model": VanillaNetwork,
            "dataset": functools.partial(in_memory_dataset, node_features=tf["node_features"], edge_features=tf["edge_features"]),
            "clustered": False,
            "entries": graph_entries,
            "check": graph_entries,
            "batch_size": bs,
            "check_batch_size": bs,
            "epochs": tf["epochs"],
            "step": {"segment_sum_sorted_kernel": 2},
            "eval": {"segment_sum_sorted_kernel": 2},
            "step_forms": {},
            "eval_forms": {},
            "grad_tol": CLUSTERED_GRAD_TOL,
        },
    )
    per_step = run["summary"]["train_passes"][0]["launches"].get("segment_sum_sorted_kernel", 0) / -(-len(graph_entries) // bs)
    if not per_step > 0:
        msg = f"trainer_featurized_vanilla: K7 launched {per_step} times a step"
        raise AssertionError(msg)
    emit({"phase": "trainer_featurized_vanilla", "card": card, "model": f"VanillaNetwork({len(graph_entries[0]['x'][0])}, 2, {graph_entries[0]['edge_attr'].shape[1]}) through Trainer.train", "k7_launches_per_step": per_step, **run["summary"], "seconds": time.perf_counter() - t_phase})

    # CnnClassification on the grids, its one checked step's gradients
    # against float64 as trainer_cnn's, but for the max-pool winners: on
    # these grids (a Gaussian over a 1 A box, nearly constant in a pool
    # window) an f32 convolution's outputs sit up to 15 (H100) and 5 (CPU)
    # units of 2^-24 S from float64, beyond the band C = 1/4 measured on
    # synthetic grids, so a winner may flip up to its chain's first-order
    # bound (f64_gate.cnn_chain_terms), the gradients then held at the
    # unchanged gate against float64 with the route's decisions
    t_phase = time.perf_counter()
    box = tuple(grid_entries[0]["x"].shape[1:])

    def grad_gate(initial, trainer, grads):
        cpu_batch, _ = trainer._collate(grid_entries[:bs], pad_graphs=bs)
        b = cpu_batch.to(dev)
        loss_of = cnn_loss(CnnClassification)
        limits = fg.cnn_chain_terms(initial)
        rows = {}
        for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
            m = CnnClassification(len(channels), box, device=device)
            m.load_state_dict(initial)
            decisions = fg.cnn_decisions(m, b.x.to(device))
            rows[side] = gate_row(fg.hold_cnn(side, grads[side], initial, b.x, lambda lg: loss_of(lg, b), decisions, raise_on_fail=side == "card", flip_limit=limits))
        return rows

    with tf32_default(torch):
        run = trainer_phase(
            torch,
            counters,
            {
                "name": "trainer_featurized_cnn",
                "model": CnnClassification,
                "dataset": functools.partial(in_memory_grid_dataset, features=channels),
                "clustered": False,
                "entries": grid_entries,
                "check": grid_entries[:bs],
                "batch_size": bs,
                "check_batch_size": bs,
                "epochs": tf["epochs"],
                "step": {},
                "eval": {},
                "step_forms": {},
                "eval_forms": {},
                "grad_gate": grad_gate,
            },
        )
    emit({"phase": "trainer_featurized_cnn", "card": card, "model": f"CnnClassification({len(channels)}, {box}) through Trainer.train", **run["summary"], "seconds": time.perf_counter() - t_phase})


def gp_kernels_phase(torch, bs, checks, card, peak, dev) -> list:
    """Phase 59: K5 at the graph-parallel row slices and ring buckets of the
    100k-node graph against its plain version and its order loop; rank 0's
    calls timed. Returns the timed calls (paths ``gp_bcsr``, ``gp_ring``)."""
    import types

    from deeprank2_tpu_torch.ops.synthetic import geometric_entry
    from deeprank2_tpu_torch.parallel import blocksparse_partition as bp
    from deeprank2_tpu_torch.tools.timing import Timer

    ranks = PARALLEL["ranks"]
    entry = geometric_entry(BCSR["nodes"], BCSR["feat"], BCSR["edge_dim"], seed=BCSR["seed"])
    t0 = time.perf_counter()
    parts, _ = bp.collate_graphs_blocksparse_partitioned([entry], ranks, device=dev)
    rings, _ = bp.collate_graphs_blocksparse_ring([entry], ranks, device=dev)
    collate_s = time.perf_counter() - t0
    n0 = len(checks.rows)
    shapes = []
    for d in range(ranks):
        shapes.append((f"row slice rank {d}", parts[d].structure))
        shapes.append((f"ring diagonal rank {d}", rings[d].diag))
        shapes += [(f"ring off-diagonal step {k} rank {d}", st) for k, st in enumerate(rings[d].off, start=1)]
    for tag, st in shapes:
        for f in (32, 64):
            x = torch.randn(f, st.padded_nodes, generator=torch.Generator(device=dev).manual_seed(f), device=dev)
            checks.close("bcsr_spmm_kernel", f"{tag} F={f}", bs.bcsr_spmm_kernel(st, x), bs.bcsr_spmm_kernel_ref(st, x), TOL, "int8/float32")
            checks.close("bcsr_spmm_kernel", f"{tag} order loop F={f}", bs.bcsr_spmm_kernel(st, x), bs.bcsr_spmm_order_ref(st, x), EXACT, "int8/float32")
    sync(torch, dev)
    timer = Timer()
    slices = types.SimpleNamespace(slice=parts[0].structure, diag=rings[0].diag, **{f"off{k}": st for k, st in enumerate(rings[0].off, start=1)})
    calls = time_bcsr_calls(torch, bs, timer, "gp_bcsr", slices, [("slice", 32, 2), ("slice", 64, 2)], peak)
    off = [(f"off{k}", f, 2) for k, has in enumerate(rings[0].off_has_blocks, start=1) if has for f in (32, 64)]
    calls += time_bcsr_calls(torch, bs, timer, "gp_ring", slices, [("diag", 32, 2), ("diag", 64, 2), *off], peak)
    del timer
    emit(
        {
            "phase": "gp_kernels_vs_plain",
            "card": card,
            "graph": f"geometric_entry({BCSR['nodes']}, {BCSR['feat']}, {BCSR['edge_dim']}), {ranks} ranks",
            "collate_s": collate_s,
            "structures": {tag: {"row_tiles": st.num_row_tiles, "column_tiles": st.num_tiles, "blocks_nonzero": int(st.tile_blocks.numel()), "blocks_stored": st.num_blocks} for tag, st in shapes},
            "tolerance": {"plain": TOL, "order loop": EXACT},
            "checks": checks.rows[n0:],
            "calls": calls,
        }
    )
    return calls


def sharded_collate_cost(cases, ranks: int) -> dict:
    """A rank's host collate of one batch of each Trainer run in ``cases``,
    every shard or part (``shard=None``) against its own alone
    (``shard=0``, what the Trainer collates): the best of three, ms, on
    this host's CPU before the ranks start."""
    from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetDense
    from deeprank2_tpu_torch.ops import batch as batches
    from deeprank2_tpu_torch.parallel import blocksparse_partition as bp

    def best_ms(fn) -> float:
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return min(times) * 1e3

    specs = {name: spec for name, fn, spec in cases if fn == "trainer_run"}
    dp = specs["trainer_dp"]
    dp_batch, per = dp["entries"][: dp["batch_size"]], -(-dp["batch_size"] // ranks)
    collates = {
        "trainer_dp": lambda shard: batches.collate_graphs_dense_sharded(dp_batch, ranks, per, with_diag_operands=GINetDense.diag_operands, device="cpu", shard=shard),
        "trainer_gp": lambda shard: bp.collate_graphs_blocksparse_partitioned(specs["trainer_gp"]["entries"], ranks, device="cpu", shard=shard),
        "trainer_ring": lambda shard: bp.collate_graphs_blocksparse_ring(specs["trainer_ring"]["entries"], ranks, device="cpu", shard=shard),
    }
    return {"ranks": ranks, "collate_ms": {name: {"every_shard": best_ms(lambda: fn(None)), "own_shard": best_ms(lambda: fn(0))} for name, fn in collates.items()}}


def parallel_phases(torch, card, record) -> None:
    """Phases 60-64: the parallel paths over PARALLEL["ranks"] ranks on this
    card, one spawn (parallel/launch.py) for all; a rank's failure raises."""
    import numpy as np

    from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetDense
    from deeprank2_tpu_torch.ops.synthetic import geometric_entry, synthetic_entries
    from deeprank2_tpu_torch.parallel import launch, probes
    from deeprank2_tpu_torch.tools import dryrun_multichip as dm

    ranks = PARALLEL["ranks"]
    bench = synthetic_entries(PARALLEL["dp_graphs"] * ranks, BENCH["nodes"], BENCH["feat"], BENCH["edge_dim"], seed=BENCH["seed"])
    entry = geometric_entry(BCSR["nodes"], BCSR["feat"], BCSR["edge_dim"], seed=BCSR["seed"])
    # the Trainer's runs: dropout-free, so the first step can be held against one rank
    trainer = {"device": "cuda", "dropout_free": True}
    gp = {
        **trainer,
        "entries": [entry],
        "batch_size": 1,
        "nepoch": PARALLEL["warm"] + PARALLEL["steps"],
        "shuffle": False,
        "one_rank": {"model": "neuralnets.gnn.ginet_blocksparse:GINetBlockSparse", "collate": "collate_graphs_blocksparse"},
    }
    cases = [
        ("dryrun_multichip", "dryrun_paths", {"device": "cuda"}),
        (
            "dp_dense",
            "dp_steps",
            {
                "warm": PARALLEL["warm"],
                "steps": PARALLEL["steps"],
                "device": "cuda",
                "model": "neuralnets.gnn.ginet_dense:GINetDense",
                "feat": BENCH["feat"],
                "edge_dim": BENCH["edge_dim"],
                "entries": bench,
                "collate": "collate_graphs_dense_sharded",
                "per_shard": PARALLEL["dp_graphs"],
                "collate_kwargs": {"pad_nodes": BENCH["nodes"]},
                "one_rank": "collate_graphs_dense",
            },
        ),
        ("trainer_gp", "trainer_run", {**gp, "model": "parallel.blocksparse_partition:GINetBlockSparseGP"}),
        ("trainer_ring", "trainer_run", {**gp, "model": "parallel.blocksparse_partition:GINetBlockSparseRing"}),
        (
            "trainer_dp",
            "trainer_run",
            {
                **trainer,
                "model": "neuralnets.gnn.ginet_dense:GINetDense",
                "dp": True,
                "entries": synthetic_entries(TRAINER["entries"], BENCH["nodes"], BENCH["feat"], BENCH["edge_dim"], seed=BENCH["seed"]),
                "batch_size": TRAINER["batch_size"],
                "nepoch": PARALLEL["trainer_epochs"],
                "one_rank": {"model": "neuralnets.gnn.ginet_dense:GINetDense", "collate": "collate_graphs_dense", "kwargs": {"with_diag_operands": GINetDense.diag_operands}},
            },
        ),
    ]
    emit({"phase": "sharded_collate_host", "card": card, **sharded_collate_cost(cases, ranks)})
    t0 = time.perf_counter()
    results = launch.run(probes.run_cases, ranks, cases, backend="gloo", timeout=PARALLEL["timeout_s"], deadline=PARALLEL["deadline_s"])
    shared = {"card": card, "ranks": ranks, "backend": "gloo", "ranks_share_one_card": True, "spawn_s": time.perf_counter() - t0}

    def per_rank(name, keys):
        return [{k: r[name][k] for k in keys if k in r[name]} for r in results]

    def full(launches):
        return {k: launches["by_kernel"].get(k, 0) for k in KERNELS}

    def replicated(name):
        """The largest difference of a parameter between rank 0 and another
        rank after the run (0: the ranks' replicas stayed equal)."""
        p0 = results[0][name]["params"]
        diff = max(float(np.abs(r[name]["params"][k] - v).max()) for r in results[1:] for k, v in p0.items())
        if diff != 0.0:
            raise AssertionError(f"{name}: the ranks' parameters differ by {diff} after the run")
        return diff

    dry = {"ranks": ranks, "backend": "gloo", "device": "cuda", "paths": results[0]["dryrun_multichip"], "comm": results[0]["dryrun_multichip"]["comm"]}
    dry["paths"] = {p: dry["paths"][p] for p in (*dm.DP_PATHS, *dm.FORWARD_PATHS)}
    ok, lines = dm.summary(dry, 1e-4)
    emit({"phase": "dryrun_multichip", **shared, "ok": ok, "lines": lines, "paths": dry["paths"], "comm": dry["comm"]})
    if not ok:
        raise AssertionError("dryrun_multichip: " + lines[0])
    for path, res in dry["paths"].items():
        record(f"dryrun:{path}", {"launches": full(res["launches"]), "launches_by_form": res["launches"]["by_form"]})

    rows = per_rank("dp_dense", ("step_s", "losses", "max_err", "comm_train", "launches_train"))
    for r in rows:
        if not (r["max_err"] < PARALLEL_TOL and all(math.isfinite(v) for v in r["losses"])):
            raise AssertionError(f"dp_dense: max_err {r['max_err']}, losses {r['losses']}")
    emit(
        {
            "phase": "dp_dense",
            **shared,
            "model": "GINetDense(38, 2, 6) data-parallel (parallel/dp.py's step), the bench batch split",
            "tolerance": PARALLEL_TOL,
            "params_max_diff_between_ranks": replicated("dp_dense"),
            "step_ms_by_rank": [r["step_s"] * 1e3 for r in rows],
            "by_rank": rows,
        }
    )
    record("dp_dense", {"launches": full(rows[0]["launches_train"]), "launches_by_form": rows[0]["launches_train"]["by_form"], "step_s": rows[0]["step_s"]})

    warm = PARALLEL["warm"]
    for name, path, what in (
        ("trainer_gp", "gp_bcsr", f"GINetBlockSparseGP(38, 2, 6) through Trainer.train, geometric_entry({BCSR['nodes']}), {PARALLEL['warm'] + PARALLEL['steps']} epochs of one step"),
        ("trainer_ring", "gp_ring", f"GINetBlockSparseRing(38, 2, 6) through Trainer.train, geometric_entry({BCSR['nodes']}), {PARALLEL['warm'] + PARALLEL['steps']} epochs of one step"),
        ("trainer_dp", "trainer_dp", f"GINetDense(38, 2, 6) through Trainer(data_parallel=True).train, {TRAINER['entries']} in-memory entries, batch_size {TRAINER['batch_size']}"),
    ):
        rows = per_rank(name, ("one_rank", "step_s", "losses", "pass_stats", "first_step", "launches", "comm", "device", "epoch_saved_model"))
        for rank, r in enumerate(rows):
            check = r["one_rank"]
            if not (check["max_err"] < PARALLEL_TOL and check["grad_err"] <= PARALLEL_TOL * max(1.0, check["grad_max"])):
                raise AssertionError(f"{name} rank {rank}: the first step against one rank: {check}")
            if rank == 0 and not (r["losses"] and all(math.isfinite(p[2]) for p in r["losses"])):
                raise AssertionError(f"{name}: rank 0 losses {r['losses']}")
            if rank > 0 and r["losses"]:
                raise AssertionError(f"{name}: rank {rank} exported {r['losses']}")
        timed = [statistics.median(r["step_s"][warm:] or r["step_s"]) for r in rows]
        hop = {"hop": "the ring's hops staged through pinned host memory (gloo's send/recv take CPU tensors only)"} if name == "trainer_ring" else {}
        emit(
            {
                "phase": name,
                **shared,
                **hop,
                "model": what,
                "tolerance": {"logits": PARALLEL_TOL, "gradients": f"{PARALLEL_TOL} x max(1, largest gradient)"},
                "params_max_diff_between_ranks": replicated(name),
                "step_ms_by_rank": [t * 1e3 for t in timed],
                "by_rank": rows,
            }
        )
        record(path, {"launches": full(rows[0]["launches"]), "launches_by_form": rows[0]["launches"]["by_form"], "step_s": timed[0]})


def parity_gates(report: dict) -> dict:
    """The gates of PARITY_GATES on one configuration's report: each gate's
    value and whether it holds (the metrics: the names that differ)."""
    import numpy as np

    g = PARITY_GATES
    out = {"max_loss_delta_rel": {"value": report["max_loss_delta_rel"], "limit": g["max_loss_delta_rel"], "ok": report["max_loss_delta_rel"] <= g["max_loss_delta_rel"]}}
    if "synced_epoch_rel_delta" in report:
        v = report["synced_epoch_rel_delta"]
        out["synced_epoch_rel_delta"] = {"value": v, "limit": g["synced_epoch_rel_delta"], "ok": v <= g["synced_epoch_rel_delta"]}
    differ = [k for k, v in report["metrics_port"].items() if not np.isclose(v, report["metrics_mirror"][k], **g["metrics"])]
    out["metrics"] = {"differ": differ, **g["metrics"], "ok": not differ}
    return out


def accuracy_parity_phase(torch, counters, card, record) -> None:
    """Phase 65: the accuracy-parity twin on the whole vendored corpus,
    featurized in memory; every gate enforced."""
    import tempfile

    from deeprank2_tpu_torch.tools import accuracy_parity as ap

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="parity-") as work:
        corpus = ap.featurize_corpus(DATA, Path(work) / "corpus", "memory")
        featurize_s = time.perf_counter() - t_phase
        counters.reset()
        reports = ap.run_all(DATA, Path(work), list(ap.CONFIG_NAMES), PARITY["epochs"], PARITY["folds"], store="memory", device="cuda", ranks=PARITY["ranks"], corpus=corpus)
        launches, forms = counters.read(), counters.read_forms()
    failed = []
    for r in reports:
        gates = parity_gates(r)
        failed += [f"{r['config']}: {name}" for name, gate in gates.items() if not gate["ok"]]
        keys = ("config", "task", "entries", "epochs", "seconds", "launches", "shards", "loss_port", "loss_mirror", "max_loss_delta", "max_loss_delta_rel", "synced_epoch_rel_delta", "synced_loss_port", "synced_loss_mirror", "metrics_port", "metrics_mirror")
        emit({"phase": "accuracy_parity", "card": card, **{k: r[k] for k in keys if k in r}, "gates": gates})
    edge = next(r for r in reports if r["config"] == "ginet_edgepart_ba")
    record("accuracy_parity", {"launches": launches, "launches_by_form": forms})
    record("accuracy_parity:ginet_edgepart_ba", {"launches": {k: edge["launches"].get(k, 0) for k in KERNELS}, "launches_by_form": {}})
    unlaunched = [k for k in PARITY_KERNELS if not launches.get(k) and not edge["launches"].get(k)]
    emit(
        {
            "phase": "accuracy_parity_summary",
            "card": card,
            "store": "memory",
            "flavors": {name: len(source) for name, source in corpus.items()},
            "featurize_s": featurize_s,
            "seconds": time.perf_counter() - t_phase,
            "launches": {k: n for k, n in launches.items() if n},
            "launches_by_form": forms,
            "edgepart_rank0_launches": edge["launches"],
            "gates": PARITY_GATES,
            "failed": failed,
            "unlaunched": unlaunched,
        }
    )
    if failed or unlaunched:
        msg = f"accuracy_parity: gates missed {failed}, kernels never launched {unlaunched}"
        raise AssertionError(msg)


def main() -> int:
    if not (HERE / "deeprank2_tpu_torch").is_dir():
        print("chip_smoke.py: the deeprank2_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this smoke run needs the card", file=sys.stderr)
        return 2

    from deeprank2_tpu_torch.neuralnets.gnn.clustered_blocksparse import GINetClusteredBlockSparse
    from deeprank2_tpu_torch.neuralnets.gnn.ginet import GINet
    from deeprank2_tpu_torch.neuralnets.gnn.ginet_blocksparse import GINetBlockSparse
    from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetClusteredDiag, GINetDense, set_dense_tower_backend
    from deeprank2_tpu_torch.neuralnets.gnn.ginet_nocluster import GINet as GINetNoCluster
    from deeprank2_tpu_torch.neuralnets.gnn.vanilla_gnn import VanillaNetwork, VanillaNetworkBlocked
    from deeprank2_tpu_torch.ops import _build
    from deeprank2_tpu_torch.ops import block_sparse as bs
    from deeprank2_tpu_torch.ops import blocked_edges as be
    from deeprank2_tpu_torch.ops import diag_spmm as ds
    from deeprank2_tpu_torch.ops import ginet_tower as gt
    from deeprank2_tpu_torch.ops import segment_sorted as ss
    from deeprank2_tpu_torch.ops import slotpool as sp
    from deeprank2_tpu_torch.ops import vanilla as vn
    from deeprank2_tpu_torch.ops.batch import (
        collate_graphs,
        collate_graphs_blocked,
        collate_graphs_blocksparse,
        collate_graphs_blocksparse_clustered,
        collate_graphs_dense,
        collate_graphs_diag_clustered,
    )
    from deeprank2_tpu_torch.ops.losses import CrossEntropyLoss
    from deeprank2_tpu_torch.ops.optim import Adam
    from deeprank2_tpu_torch.ops.pooling import community_pool
    from deeprank2_tpu_torch.ops.synthetic import clustered_entry, geometric_entry, ppi_clustered_entries, synthetic_entries
    from deeprank2_tpu_torch.tools import diag_order as do
    from deeprank2_tpu_torch.tools import f64_gate as fg
    from deeprank2_tpu_torch.tools.timing import Timer

    # 1. device and build (one nvcc per source, all at once)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    part, peak = peaks(kind)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build([ds.SOURCE, sp.SOURCE, bs.SOURCE, vn.SOURCE, ss.SOURCE, gt.SOURCE, ds.TOWER_SOURCE])
    build_s = time.perf_counter() - t0
    emit(
        {
            "phase": "device_and_build",
            "card": card,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "python": sys.version.split()[0],
            "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32, "cudnn": torch.backends.cudnn.allow_tf32},
            "build_s": build_s,
            "ptxas": [ln.strip() for log in _build.build_logs.values() for ln in log.splitlines() if "registers" in ln or "Compiling" in ln or "spill" in ln],
            "peaks": {"part": part, "bytes_per_s": peak[0], "f32_flop_per_s": peak[1], "bf16_tensor_flop_per_s": peak[2]},
        }
    )
    counters = Counters(ds, sp, bs, vn, ss, gt)

    # 2. kernels against their plain versions, and their times
    dev = torch.device("cuda")
    entries = synthetic_entries(BENCH["num_graphs"], BENCH["nodes"], BENCH["feat"], BENCH["edge_dim"], seed=BENCH["seed"])
    batch, _ = collate_graphs_dense(entries, pad_graphs=BENCH["num_graphs"], pad_nodes=BENCH["nodes"], device=dev)
    ragged, _ = collate_graphs_dense(do.ragged_entries(), pad_nodes=96, device=dev)
    c_entries = ppi_clustered_entries(CLUSTERED["num_graphs"], CLUSTERED["nodes"], CLUSTERED["feat"], seed=CLUSTERED["seed"])
    c_batch, _ = collate_graphs_diag_clustered(c_entries, device=dev)
    c_mask_row = c_batch.node_mask.float().reshape(1, -1)
    m_entries = ppi_clustered_entries(CLUSTERED["num_graphs"], CLUSTERED["nodes"], CLUSTERED["feat"], cell=MIXED_CELL, seed=CLUSTERED["seed"])
    m_batch, _ = collate_graphs_diag_clustered(m_entries, device=dev)
    checks = Checks(torch)
    check_diag_kernels(
        torch,
        ds,
        checks,
        [
            ("bench G=512 N=160", batch.adj_i8, batch.node_mask, (32, 64)),
            ("bench G=512 N=160 as f32 (FMA body)", batch.adj_i8.float(), batch.node_mask, (32,)),
            ("clustered G=512 N=296", c_batch.adj_i8, c_batch.node_mask, (32,)),
            ("pooled G=512 K=32", c_batch.adj_p_i8, c_batch.pooled_mask, (64,)),
            (f"mixed G=512 N={m_batch.nodes_per_graph}", m_batch.adj_i8, m_batch.node_mask, (32,)),
            (f"mixed pooled G=512 K={m_batch.pooled_mask.shape[1]}", m_batch.adj_p_i8, m_batch.pooled_mask, (64,)),
            ("ragged G=7 N=96", ragged.adj_i8, ragged.node_mask, (38,)),
        ],
        dev,
    )
    check_slot_kernels(
        torch,
        sp,
        checks,
        [
            ("clustered F=32 V=151552", 32, c_mask_row.shape[1], None, (8, 4, 2)),
            ("ragged F=38 V=8024", 38, 8 * 1000 + 8 * 3, None, (8, 4, 2)),
            *mixed_region_shapes(m_batch, 32),
        ],
        dev,
    )
    emit({"phase": "kernels_vs_plain", "tolerance": {"diag_kernel": TOL, "pool_bwd_kernel": TOL, "slot_fwd_kernel": EXACT, "slot_bwd_kernel": EXACT}, "checks": checks.rows})
    n_checks = len(checks.rows)
    timer = Timer()
    calls = time_diag_calls(torch, ds, timer, "dense", batch.adj_i8, batch.node_mask, STEP_CALLS["dense"], peak)
    calls += time_diag_calls(torch, ds, timer, "clustered", c_batch.adj_i8, c_batch.node_mask, STEP_CALLS["clustered"], peak)
    calls += time_diag_calls(torch, ds, timer, "clustered_pooled", c_batch.adj_p_i8, c_batch.pooled_mask, STEP_CALLS["clustered_pooled"], peak)
    calls += time_slot_calls(torch, sp, timer, "clustered_slot", c_mask_row, STEP_CALLS["clustered_slot"], peak)
    calls += time_diag_calls(torch, ds, timer, "clustered_mixed", m_batch.adj_i8, m_batch.node_mask, STEP_CALLS["clustered"], peak)
    calls += time_diag_calls(torch, ds, timer, "clustered_mixed_pooled", m_batch.adj_p_i8, m_batch.pooled_mask, STEP_CALLS["clustered_pooled"], peak)
    for _, f, _, region_mask, (slot,) in mixed_region_shapes(m_batch, 32):
        calls += time_slot_calls(torch, sp, timer, "clustered_mixed_slot", region_mask, [("slot_fwd_kernel", slot, f), ("slot_bwd_kernel", slot, f)], peak)
    # the f32 adjacency (the FMA body) at the bench shape, on no path's step
    fma_calls = time_diag_calls(
        torch, ds, timer, "f32_adjacency", batch.adj_i8.float(), batch.node_mask, [("diag_kernel", "plain", 32, 0), ("pool_bwd_kernel", None, 64, 0)], peak
    )
    # K1's int8 f32 form on the FMA body, which ran it before the tensor
    # cores, at the dense and clustered paths' calls (on no path's step)
    with do.on_body("fma"):
        for path, adj, mask, specs in (
            ("dense", batch.adj_i8, batch.node_mask, STEP_CALLS["dense"]),
            ("clustered", c_batch.adj_i8, c_batch.node_mask, STEP_CALLS["clustered"]),
            ("clustered_pooled", c_batch.adj_p_i8, c_batch.pooled_mask, STEP_CALLS["clustered_pooled"]),
            ("clustered_mixed", m_batch.adj_i8, m_batch.node_mask, STEP_CALLS["clustered"]),
            ("clustered_mixed_pooled", m_batch.adj_p_i8, m_batch.pooled_mask, STEP_CALLS["clustered_pooled"]),
        ):
            fma_calls += time_diag_calls(torch, ds, timer, f"{path} (FMA body)", adj, mask, [(k, m, f, 0) for k, m, f in specs if k == "diag_kernel"], peak)
    del timer
    emit({"phase": "kernel_times", "card": card, "l2_flushed": True, "calls": calls, "fma_body_calls": fma_calls})
    del m_batch

    # 3. the dense path
    model = GINetDense(BENCH["feat"], 2, BENCH["edge_dim"], device=dev, generator=torch.Generator().manual_seed(0))
    loss_fn = CrossEntropyLoss()
    step, _, _ = card_vs_cpu_step(torch, model, batch, loss_fn, lambda: GINetDense(BENCH["feat"], 2, BENCH["edge_dim"], device="cpu"), STEP_TOL, STEP_TOL)
    emit({"phase": "card_vs_cpu_step", "tolerance": STEP_TOL, **step})
    opt = Adam(model.parameters(), lr=1e-3, weight_decay=1e-5)
    want = want_launches(diag_kernel=3 * STEPS + 2, pool_bwd_kernel=STEPS)
    run = run_main_path(torch, counters, model, batch, loss_fn, opt, dev, want, STEPS)
    real_edges = int(sum(2 * e["edge_index"].shape[0] for e in entries))
    train_step = run.pop("train_step")
    emit(
        {
            "phase": "main_path",
            "card": card,
            "model": "GINetDense(38, 2, 6)",
            "batch": BENCH,
            **run,
            "step_ms": run["step_s"] * 1e3,
            "edges_per_s": real_edges / run["step_s"],
            "real_edges": real_edges,
        }
    )
    path_launches, path_forms, path_step_s = {}, {}, {}

    def record(path, run):
        path_launches[path] = run["launches"]
        path_forms[path] = run.get("launches_by_form", {})
        if "step_s" in run:
            path_step_s[path] = run["step_s"]

    record("dense", run)
    dense_step_s = run["step_s"]

    # 4. profile of a few dense steps (after the counted run)
    emit({"phase": "profile", "card": card, **profile_steps(torch, train_step, run["step_s"])})
    del model, opt, batch, train_step

    # 5-6. the clustered path, pure slot8 layout, and its profile
    def pure_layout(b):
        if b.region_caps != () or tuple(b.adj_i8.shape) != (512, 296, 296):
            msg = f"expected the pure slot8 layout at [512, 296, 296], got {b.region_caps} {tuple(b.adj_i8.shape)}"
            raise AssertionError(msg)

    pure = clustered_path(torch, ds, fg, counters, card, c_entries, pure_layout, CLUSTERED_STEPS, dev, "main_path_clustered")
    record("clustered", pure)
    emit({"phase": "profile_clustered", "card": card, **profile_steps(torch, pure["train_step"], pure["step_s"])})
    del pure

    # 7. the clustered path, mixed size-class layout
    def mixed_layout(b):
        if not b.region_caps or not all(b.region_caps[:3]):
            msg = f"expected the mixed layout with slot8, stride-4 and stride-2 regions, got {b.region_caps}"
            raise AssertionError(msg)

    mixed = clustered_path(torch, ds, fg, counters, card, m_entries, mixed_layout, MIXED_STEPS, dev, "main_path_clustered_mixed")
    record("clustered_mixed", mixed)
    del mixed

    # 8. the BCSR kernel against its plain version, and its times
    t0 = time.perf_counter()
    entry = geometric_entry(BCSR["nodes"], BCSR["feat"], BCSR["edge_dim"], seed=BCSR["seed"])
    b_batch, _ = collate_graphs_blocksparse([entry], device=dev)
    bcsr_collate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    c_entry = clustered_entry(CLUSTERED_BCSR["nodes"], CLUSTERED_BCSR["feat"], CLUSTERED_BCSR["edge_dim"], seed=CLUSTERED_BCSR["seed"])
    cb_batch, _ = collate_graphs_blocksparse_clustered([c_entry], slot8=True, device=dev)
    clustered_bcsr_collate_s = time.perf_counter() - t0
    ragged_bcsr, _ = collate_graphs_blocksparse([geometric_entry(700, 38, 1, seed=1), geometric_entry(1300, 38, 1, seed=2)], pad_graphs=3, device=dev)
    no_edges = {**geometric_entry(300, 38, 1, seed=3), "edge_index": np.zeros((0, 2), np.int64)}
    empty_bcsr, _ = collate_graphs_blocksparse([no_edges], device=dev)
    cb_mask_row = cb_batch.node_mask.float().reshape(1, -1)
    check_bcsr_kernel(
        torch,
        bs,
        checks,
        [
            (f"bcsr {b_batch.structure.num_chunks} chunks", b_batch.structure, (32, 64)),
            (f"clustered_bcsr full {cb_batch.structure.num_chunks} chunks", cb_batch.structure, (32,)),
            ("clustered_bcsr pooled", cb_batch.structure_p, (64,)),
            ("ragged 700+1300+empty graph", ragged_bcsr.structure, (38,)),
            ("no edges", empty_bcsr.structure, (32,)),
            ("bcsr signed int8 {-2, -1, 0, 1, 3}", signed_structure(torch, b_batch.structure, seed=5), (32,)),
        ],
        dev,
    )
    check_bcsr_order(
        torch,
        bs,
        checks,
        [
            ("bcsr", b_batch.structure, (32, 64)),
            ("clustered_bcsr full", cb_batch.structure, (32,)),
            ("clustered_bcsr pooled", cb_batch.structure_p, (64,)),
        ],
        dev,
    )
    check_slot_kernels(torch, sp, checks, [(f"clustered_bcsr F=32 V={cb_mask_row.shape[1]}", 32, cb_mask_row.shape[1], cb_mask_row, (8,))], dev)
    tolerance = {
        "bcsr_spmm_kernel": TOL,
        "bcsr_spmm_kernel signed int8": {"rtol": 1e-5, "atol": f"max(1e-5, {DW_TOL} * max |A| |x|)"},
        "bcsr_spmm_kernel order loop": EXACT,
        "slot_fwd_kernel": EXACT,
        "slot_bwd_kernel": EXACT,
    }
    emit({"phase": "bcsr_kernels_vs_plain", "tolerance": tolerance, "checks": checks.rows[n_checks:]})
    timer = Timer()
    bcsr_calls = time_bcsr_calls(torch, bs, timer, "bcsr", b_batch, BCSR_STEP_CALLS["bcsr"], peak)
    bcsr_calls += time_bcsr_calls(torch, bs, timer, "clustered_bcsr", cb_batch, BCSR_STEP_CALLS["clustered_bcsr"], peak)
    bcsr_calls += time_slot_calls(torch, sp, timer, "clustered_bcsr_slot", cb_mask_row, STEP_CALLS["clustered_bcsr_slot"], peak)
    del timer, ragged_bcsr, empty_bcsr
    emit({"phase": "bcsr_kernel_times", "card": card, "l2_flushed": True, "calls": bcsr_calls})
    calls += bcsr_calls

    # 9. the BCSR path and its profile
    def structure_info(st):
        return {"tiles": st.num_tiles, "chunks": st.num_chunks, "blocks_stored": st.num_blocks, "blocks_nonzero": st.tile_blocks.numel()}

    record("bcsr", checked_path(
        torch,
        counters,
        card,
        b_batch,
        lambda d: GINetBlockSparse(BCSR["feat"], 2, BCSR["edge_dim"], device=d, generator=torch.Generator().manual_seed(0)),
        want_launches(bcsr_spmm_kernel=4 * BCSR_STEPS + 2),
        dev,
        "main_path_bcsr",
        {
            "model": "GINetBlockSparse(38, 2, 6)",
            "batch": {**BCSR, "structure": structure_info(b_batch.structure)},
            "collate_s": bcsr_collate_s,
            "undirected_edges": int(entry["edge_index"].shape[0]),
        },
    ))

    # 10. the clustered BCSR path and its profile
    record("clustered_bcsr", checked_path(
        torch,
        counters,
        card,
        cb_batch,
        lambda d: GINetClusteredBlockSparse(CLUSTERED_BCSR["feat"], 2, CLUSTERED_BCSR["edge_dim"], device=d, generator=torch.Generator().manual_seed(0)),
        want_launches(bcsr_spmm_kernel=4 * BCSR_STEPS + 2, slot_fwd_kernel=BCSR_STEPS + 1, slot_bwd_kernel=BCSR_STEPS),
        dev,
        "main_path_clustered_bcsr",
        {
            "model": "GINetClusteredBlockSparse(38, 2, 1)",
            "batch": {
                **CLUSTERED_BCSR,
                "structure": structure_info(cb_batch.structure),
                "structure_p": structure_info(cb_batch.structure_p),
                "members0s": list(cb_batch.members0s.shape),
                "members1": list(cb_batch.members1.shape),
            },
            "collate_s": clustered_bcsr_collate_s,
            "undirected_edges": int(c_entry["edge_index"].shape[0]),
        },
        flips=lambda *a: bcsr_winner_flips(torch, bs, *a),
    ))

    # 11. the blocked-edge kernels against their plain versions, and their times
    t0 = time.perf_counter()
    bl_batch, _ = collate_graphs_blocked([entry], device=dev)  # the BCSR path's graph
    blocked_collate_s = time.perf_counter() - t0
    edgeless = {**geometric_entry(300, 38, 6, seed=3), "edge_index": np.zeros((0, 2), np.int64), "edge_attr": np.zeros((0, 6), np.float32)}
    ragged_bl, _ = collate_graphs_blocked([geometric_entry(700, 38, 6, seed=1), geometric_entry(1300, 38, 6, seed=2), edgeless], pad_graphs=4, device=dev)
    padded_bl, _ = collate_graphs_blocked([geometric_entry(2000, 38, 6, seed=4)], pad_slabs=lambda required: required + 3, device=dev)
    empty_bl, _ = collate_graphs_blocked([edgeless], device=dev)
    n_checks = len(checks.rows)
    check_blocked_kernels(
        torch,
        be,
        vn,
        checks,
        [
            ("atomic 100k", bl_batch.structure, (32, 12)),
            ("ragged 700+1300+edgeless+empty graph", ragged_bl.structure, (32,)),
            ("three capacity-pad slabs", padded_bl.structure, (32,)),
            ("no edges", empty_bl.structure, (32,)),
        ],
        dev,
    )
    emit({"phase": "blocked_kernels_vs_plain", "tolerance": {"out, dxr, dxc": TOL, "order loop": EXACT, "dw_e": {"rtol": 1e-5, "atol": f"{DW_TOL} * max sum_e |e_attr| |g[row]|"}}, "checks": checks.rows[n_checks:]})
    del ragged_bl, padded_bl, empty_bl
    timer = Timer()
    blocked_calls = time_blocked_calls(torch, vn, timer, "blocked", bl_batch.structure, 32, 2, peak)
    del timer
    emit({"phase": "blocked_kernel_times", "card": card, "l2_flushed": True, "calls": blocked_calls})
    calls += blocked_calls

    # 12. the blocked-edge path and its profile
    st = bl_batch.structure
    record("blocked", checked_path(
        torch,
        counters,
        card,
        bl_batch,
        lambda d: VanillaNetworkBlocked(BCSR["feat"], 2, BCSR["edge_dim"], device=d, generator=torch.Generator().manual_seed(0)),
        want_launches(blocked_fwd_kernel=2 * BCSR_STEPS + 2, blocked_bwd_kernel=2 * BCSR_STEPS),
        dev,
        "main_path_blocked",
        {
            "model": "VanillaNetworkBlocked(38, 2, 6)",
            "batch": {
                **BCSR,
                "structure": {"tiles": st.num_node_tiles, "slabs": st.num_slabs, "edge_slots": st.row_local.numel(), "real_edges": st.edge_order.numel(), "fe_pad": st.eattr_t.shape[0],
                              "stream_bytes": st.edge_src.numel() * st.edge_src.element_size() + st.edge_feat.numel() * st.edge_feat.element_size()},
            },
            "collate_s": blocked_collate_s,
            "undirected_edges": int(entry["edge_index"].shape[0]),
        },
    ))
    del st

    # 13. the sorted segment-sum kernel against its plain version, and its times
    t0 = time.perf_counter()
    coo_batch, _ = collate_graphs(entries, device=dev)
    coo_collate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cc_batch, _ = collate_graphs(c_entries, device=dev)
    coo_clustered_collate_s = time.perf_counter() - t0
    atomic_coo, _ = collate_graphs([entry], device=dev)
    v_coo, v_cc, v_atomic = coo_batch.num_nodes, cc_batch.num_nodes, atomic_coo.num_nodes
    pooled_rows = community_pool(
        torch.zeros(v_cc, 1, device=dev), cc_batch.pos, cc_batch.edge_index, cc_batch.edge_attr, cc_batch.edge_mask, cc_batch.node_graph, cc_batch.cluster0, cc_batch.num_graphs
    )[2][0].contiguous()
    gen = torch.Generator(device=dev).manual_seed(15)
    ragged_n, ragged_e = 5000, 40000
    ragged_rows = torch.sort(torch.randint(0, ragged_n, (ragged_e,), generator=gen, device=dev)).values.to(torch.int32)
    ragged_rows = ragged_rows[(ragged_rows <= 100) | (ragged_rows >= 400)]  # 299 segments without messages
    ragged_rows[-123:] = ragged_n + 7
    coo_rows, cc_rows = coo_batch.edge_index[0].contiguous(), cc_batch.edge_index[0].contiguous()
    n_checks = len(checks.rows)
    check_segment_kernel(
        torch,
        ss,
        checks,
        [
            (f"coo E={coo_rows.numel()}", coo_rows, v_coo, 16, False),
            (f"coo E={coo_rows.numel()}", coo_rows, v_coo, 32, False),
            (f"coo_clustered full E={cc_rows.numel()}", cc_rows, v_cc, 16, False),
            (f"coo_clustered pooled E={pooled_rows.numel()}", pooled_rows, v_cc, 32, False),
            ("coo_vanilla messages (relu)", coo_rows, v_coo, 32, True),
            (f"atomic 100k E={atomic_coo.num_edges}", atomic_coo.edge_index[0].contiguous(), v_atomic, 32, False),
            ("ragged n=5000 padding n+7", ragged_rows, ragged_n, 12, False),
            ("E=0", torch.zeros(0, dtype=torch.int32, device=dev), 100, 32, False),
        ],
        dev,
    )
    emit({"phase": "segment_kernel_vs_plain", "tolerance": {"segment_sum_sorted_kernel": TOL}, "checks": checks.rows[n_checks:]})
    timer = Timer()
    segment_calls = time_segment_calls(
        torch, ss, timer, {"coo": (coo_rows, v_coo), "coo_clustered": (cc_rows, v_cc), "coo_clustered_pooled": (pooled_rows, v_cc)}, peak
    )
    del timer, ragged_rows, pooled_rows
    emit({"phase": "segment_kernel_times", "card": card, "l2_flushed": True, "calls": segment_calls})
    calls += segment_calls

    # 14. the COO paths, each checked against the CPU, counted and profiled
    def coo_describe(model, batch_info, collate_s, batch, undirected):
        return {
            "model": model,
            "batch": {**batch_info, "layout": "coo", "nodes_cap": batch.num_nodes, "edges_cap": batch.num_edges},
            "collate_s": collate_s,
            "undirected_edges": undirected,
        }

    bench_undirected = int(sum(e["edge_index"].shape[0] for e in entries))
    record("coo", checked_path(
        torch,
        counters,
        card,
        coo_batch,
        lambda d: GINetNoCluster(BENCH["feat"], 2, BENCH["edge_dim"], device=d, generator=torch.Generator().manual_seed(0)),
        want_launches(segment_sum_sorted_kernel=4 * SEGMENT_STEPS + 4),
        dev,
        "main_path_coo",
        coo_describe("GINet no-cluster (38, 2, 6)", BENCH, coo_collate_s, coo_batch, bench_undirected),
        steps=SEGMENT_STEPS,
    ))
    record("coo_clustered", checked_path(
        torch,
        counters,
        card,
        cc_batch,
        lambda d: GINet(CLUSTERED["feat"], 2, 1, device=d, generator=torch.Generator().manual_seed(0)),
        want_launches(segment_sum_sorted_kernel=4 * SEGMENT_STEPS + 4),
        dev,
        "main_path_coo_clustered",
        coo_describe("GINet clustered (38, 2, 1)", CLUSTERED, coo_clustered_collate_s, cc_batch, int(sum(e["edge_index"].shape[0] for e in c_entries))),
        steps=SEGMENT_STEPS,
    ))
    record("coo_vanilla", checked_path(
        torch,
        counters,
        card,
        coo_batch,
        lambda d: VanillaNetwork(BENCH["feat"], 2, BENCH["edge_dim"], device=d, generator=torch.Generator().manual_seed(0)),
        want_launches(segment_sum_sorted_kernel=2 * SEGMENT_STEPS + 2),
        dev,
        "main_path_coo_vanilla",
        coo_describe("VanillaNetwork(38, 2, 6)", BENCH, coo_collate_s, coo_batch, bench_undirected),
        steps=SEGMENT_STEPS,
    ))

    # 15. the host time of the segment ops' earlier boolean masks
    emit(host_sync_probe(torch, card, GINet(CLUSTERED["feat"], 2, 1, device=dev, generator=torch.Generator().manual_seed(0)), cc_batch, SYNC_PROBE_STEPS, dev))

    # 16. the fast paths against their COO oracle (card-only forwards)
    dense_batch, _ = collate_graphs_dense(entries, pad_graphs=BENCH["num_graphs"], pad_nodes=BENCH["nodes"], device=dev)
    diag_batch, _ = collate_graphs_diag_clustered(c_entries, device=dev)
    oracle = GINetNoCluster(BCSR["feat"], 2, BCSR["edge_dim"], device=dev, generator=torch.Generator().manual_seed(3))
    cross = [
        cross_check(
            torch, "GINetDense vs GINet no-cluster, bench batch", oracle, coo_batch, GINetDense(BENCH["feat"], 2, BENCH["edge_dim"], device=dev), dense_batch,
            tower_gate=ginet_dense_gate(torch, ds, fg, "GINetDense flat route (K1, K2)", flat=True),
        ),
        cross_check(torch, "GINetBlockSparse vs GINet no-cluster, atomic 100k", oracle, atomic_coo, GINetBlockSparse(BCSR["feat"], 2, BCSR["edge_dim"], device=dev), b_batch),
    ]
    set_dense_tower_backend("pallas")
    try:
        cross.append(
            cross_check(
                torch, "GINetDense (pallas tower backend) vs GINet no-cluster, bench batch", oracle, coo_batch, GINetDense(BENCH["feat"], 2, BENCH["edge_dim"], device=dev), dense_batch,
                tower_gate=ginet_dense_gate(torch, ds, fg, "GINetDense batched tower (K8)", flat=False),
            )
        )
    finally:
        set_dense_tower_backend("xla")
    c_oracle = GINet(CLUSTERED["feat"], 2, 1, device=dev, generator=torch.Generator().manual_seed(3))
    diag_model = GINetClusteredDiag(CLUSTERED["feat"], 2, 1, device=dev)
    # the conv weights' gradients pass through the max pools, whose tie rules
    # differ (full_tie_pools): reported under both rules, gated under neither
    head_only = lambda name: not name.startswith("conv")  # noqa: E731
    for rule, context in (("shared ties", contextlib.nullcontext), ("full-cotangent ties", lambda: full_tie_pools(torch))):
        cross.append(
            cross_check(torch, f"GINetClusteredDiag vs GINet clustered ({rule})", c_oracle, cc_batch, diag_model, diag_batch, CLUSTERED_GATE, context, head_only)
        )
    del diag_batch
    v_oracle = VanillaNetwork(BCSR["feat"], 2, BCSR["edge_dim"], device=dev, generator=torch.Generator().manual_seed(3))
    cross.append(cross_check(torch, "VanillaNetworkBlocked vs VanillaNetwork, atomic 100k", v_oracle, atomic_coo, VanillaNetworkBlocked(BCSR["feat"], 2, BCSR["edge_dim"], device=dev), bl_batch))
    del atomic_coo, coo_batch
    emit({"phase": "coo_cross_checks", "checks": cross})

    # 17. the fused tower kernels against their plain versions, and their times
    tower_model = GINetDense(BENCH["feat"], 2, BENCH["edge_dim"], device=dev, generator=torch.Generator().manual_seed(0))
    w1, w2 = tower_weights(tower_model)
    # each family's largest N: K8's (gt.supports) and K9's (ds.tower_supports)
    n_max = {
        "batched": max(n for n in range(1, 1025) if gt.supports(1, n, BENCH["feat"])),
        "flat": max(n for n in range(1, 1025) if ds.tower_supports(1, n, BENCH["feat"])),
    }
    shapes = {family: do.tower_shapes(dev, n) for family, n in n_max.items()}
    tower_shapes = {family: [("bench G=512 N=160", dense_batch), *rows] for family, rows in shapes.items()}
    n_checks = len(checks.rows)
    check_tower_kernels(torch, gt, ds, fg, checks, tower_shapes, w1, w2, dev)
    emit(
        {
            "phase": "tower_kernels_vs_plain",
            "tolerance": {
                "pooled, h1": TOL,
                "dw1, dw2, t1, t2": {"rtol": 1e-5, "atol": f"max(1e-5, {DW_TOL} * sum of |products|)"},
                "sign": "exact where |h2| > 1e-6 max|h2|",
                "K9f h1, sign vs the order loop; K9b t2 vs fl(g_pool x count)": EXACT,
                "tower_pooled dw1, dw2": f"against float64: atol max({fg.ATOL}, {fg.C} * 2^-24 * sum of |products|), rtol {fg.RTOL}",
            },
            "largest_supported_nodes": n_max,
            "checks": checks.rows[n_checks:],
        }
    )
    timer = Timer()
    tower_calls = time_tower_calls(torch, gt, ds, timer, dense_batch, w1, w2, peak)
    del timer
    emit({"phase": "tower_kernel_times", "card": card, "l2_flushed": True, "calls": tower_calls})
    calls += tower_calls

    # 18. the dense path on the batched tower backend, and its profile
    set_dense_tower_backend("pallas")
    try:
        model = GINetDense(BENCH["feat"], 2, BENCH["edge_dim"], device=dev, generator=torch.Generator().manual_seed(0))
        step, _, _ = card_vs_cpu_step(torch, model, dense_batch, loss_fn, lambda: GINetDense(BENCH["feat"], 2, BENCH["edge_dim"], device="cpu"), STEP_TOL, STEP_TOL)
        emit({"phase": "dense_tower_card_vs_cpu_step", "tolerance": STEP_TOL, **step})
        opt = Adam(model.parameters(), lr=1e-3, weight_decay=1e-5)
        want = want_launches(ginet_tower_fwd_kernel=STEPS + 1, ginet_tower_bwd_kernel=STEPS)
        run = run_main_path(torch, counters, model, dense_batch, loss_fn, opt, dev, want, STEPS)
        train_step = run.pop("train_step")
        emit({"phase": "main_path_dense_tower", "card": card, "model": "GINetDense(38, 2, 6), tower backend pallas", "batch": BENCH, **run, "step_ms": run["step_s"] * 1e3, "edges_per_s": real_edges / run["step_s"], "real_edges": real_edges})
        record("dense_tower", run)
        emit({"phase": "profile_dense_tower", "card": card, **profile_steps(torch, train_step, run["step_s"])})
        del model, opt, train_step
    finally:
        set_dense_tower_backend("xla")

    # 19. the fused flat tower (tower_pooled) on the bench batch
    fused = fused_tower_drive(torch, ds, fg, do, counters, dense_batch, w1, w2, STEPS, dev)
    emit({"phase": "dense_fused_tower", "card": card, "weights": "GINetDense(38, 2, 6) fused, torch seed 0", "batch": BENCH, **fused})
    record("dense_fused_tower", fused)

    # 20-26. FoutNet and sGAT on the clustered fast paths, with the weighted
    # forms of K5 and K1
    sgat_foutnet_calls, f32_calls, sd_batch, sw_batch = sgat_foutnet_phases(
        torch, dev, card, counters, checks, peak, record, c_entries, c_batch, c_entry, cb_batch, cc_batch
    )
    calls += sgat_foutnet_calls
    del cc_batch

    # 27-32. the single-pass bf16 forms of K1, K2, K5, K6f and K6b, and the bf16 paths
    bf16_calls, bf16_form_calls = bf16_phases(
        torch,
        dev,
        card,
        counters,
        checks,
        peak,
        record,
        {"dense_batch": dense_batch, "c_batch": c_batch, "b_batch": b_batch, "cb_batch": cb_batch, "bl_batch": bl_batch, "sd_batch": sd_batch, "sw_batch": sw_batch},
        {"dense": bench_undirected, "bcsr": int(entry["edge_index"].shape[0]), "clustered_bcsr": int(c_entry["edge_index"].shape[0])},
    )
    calls += bf16_calls
    del b_batch, bl_batch

    # 33-36. the bf16 forms of the fused towers, the dense_tower_bf16 path and the dense_fused_tower_bf16 drive
    calls += bf16_tower_phases(torch, dev, card, counters, checks, peak, record, dense_batch, tower_shapes, loss_fn, real_edges)
    del tower_shapes, shapes, ragged

    # 37-41. FoutNet and sGAT in bf16 on the Diag and BCSR paths, and SGATDiag in bf16 on an f32 adjacency
    calls += bf16_sgat_foutnet_phases(torch, dev, card, counters, peak, record, c_entries, c_batch, sd_batch, c_entry, cb_batch, sw_batch)
    del dense_batch, c_batch, cb_batch, sd_batch, sw_batch

    # 42. the dense path through the Trainer
    dense_entries = synthetic_entries(TRAINER["entries"], BENCH["nodes"], BENCH["feat"], BENCH["edge_dim"], seed=BENCH["seed"])
    trainer_run = trainer_phase(
        torch,
        counters,
        {
            "name": "trainer_dense",
            "model": GINetDense,
            "clustered": False,
            "entries": dense_entries,
            "check": dense_entries[: TRAINER["check_entries"]],
            "batch_size": TRAINER["batch_size"],
            "check_batch_size": TRAINER["batch_size"],
            "epochs": TRAINER["epochs"],
            "step": {"diag_kernel": 3, "pool_bwd_kernel": 1},
            "eval": {"diag_kernel": 2},
            "step_forms": {k: (3 if k.startswith("diag_kernel") else 1) for k in path_forms["dense"]},
            "eval_forms": {k: 2 for k in path_forms["dense"] if k.startswith("diag_kernel")},
            "grad_tol": STEP_TOL,
            "bare_step_s": dense_step_s,
        },
    )
    record("trainer_dense", trainer_run)
    emit({"phase": "trainer_dense", "card": card, "model": "GINetDense(38, 2, 6) through Trainer.train", "batch_shape": "[512, 192, 192] (the dense collate buckets N=160 to 192)", **trainer_run["summary"]})
    del dense_entries, trainer_run

    # 43-46. the atomic-resolution models through the Trainer, and 47 the
    # kernels at the padded shapes their buckets gave
    caps, geo, clu = trainer_atomic_phases(torch, counters, record, path_step_s)
    emit(padded_kernels_phase(torch, checks, caps, geo, clu, dev))
    del geo, clu

    # 48. the batched dense family through the Trainer
    trainer_dense_family_phase(torch, counters, record)

    # 49. GINetDense beyond K1's shared memory: its batched branch
    emit({"card": card, **ginet_dense_batched_phase(torch, counters, dev)})

    # 50-53. the grid path (the CNNs, tied pooling windows, the Trainer's
    # grid branch) and 54 AlignmentGNN: no kernel of K1-K9, so nothing of
    # theirs enters the kernels line
    grid_phases(torch, counters, card, peak, dev)
    emit(alignment_phase(torch, counters, card, dev))

    # 55-58. the featurization on the host (its native kernels, the PPI and
    # SRV protocols) and the Trainer on its output: K7 through VanillaNetwork,
    # no other kernel of K1-K9
    emit(native_host_phase(card))
    featurize_phases(card)
    trainer_featurized_phase(torch, counters, card, dev)

    # 59. K5 at the graph-parallel row slices and ring buckets; 60-64 the
    # parallel paths over ranks sharing the card
    calls += gp_kernels_phase(torch, bs, checks, card, peak, dev)
    parallel_phases(torch, card, record)

    # 65. the accuracy-parity twin: all twelve configurations on the corpus
    accuracy_parity_phase(torch, counters, card, record)

    emit({"kernels": kernels_line(calls, path_launches, checks.errs, path_forms, checks.form_errs, fma_calls + f32_calls + bf16_form_calls)})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
