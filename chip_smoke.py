#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel) and prints the build seconds.
2. Drives the main path at the full width of the ``lightgcn-baco`` config:
   ``paperlike_dataset("amazonbook")`` -> ``ClusterEngine().build(d=64,
   ratio=0.25)`` on the GPU -> training: ``Trainer`` with the launcher's
   defaults (fused backend, 600 steps of batch 2,048, lr 5e-3, chunks of
   16), ms per step (median of the chunks after the first), first and
   last loss, Recall/NDCG@20 on the test split (4,096 users, "block" and
   "fused" top-k) of the untrained ``init_params(0)`` and the trained
   codebooks, one warm chunk under ``torch.cuda.set_sync_debug_mode(
   "error")`` -> ``Trainer.export`` -> artifact load -> ``RecsysSession``
   (fused and dense, fp32 and int8) over the trained codebooks behind
   ``BatchDispatcher((1, 8, 64, 512))`` -> 52 requests. Training and
   serving each zero the kernels' launch counts just before and read them
   just after; each kernel of the path must have run. Training must lower
   the loss and raise Recall@20. Off the timed path: 32 steps of ``host``
   with the device sampler bitwise equal to ``fused``, and a kill at step
   32 and resume from its checkpoint bitwise equal to 64 uninterrupted
   steps. Fused and dense top-k must agree (ids equal up to near-ties),
   and two GPU solves must give identical labels.
   Then the same path over a ``torch.distributed`` world of 1 (NCCL on
   the card, on a localhost store, destroyed when the phase ends):
   ``ClusterEngine(solver="torch_sharded", mesh=cluster_mesh())`` must
   give the main path's sketch bitwise in as many sweeps (both build
   times printed), and ``fused_sharded`` must train bitwise ``fused``
   over 64 steps (chunks of 16, interleaved and timed, one under
   sync-debug "error") with equal launches a step; the compression
   functions on the card must equal the CPU's (a gloo world of 1). It
   prints a ``sharded`` JSON line; its solve and sharded training count
   into the kernels line's launches.
   Then the stream (``repro_torch.stream``) at amazonbook's width
   (``STREAM_ARGS``: 52,643 users, 91,599 items, k_true 300, 4 waves
   after a warm prefix of 31,586 x 54,959): BACO (d 64, ratio 0.25) and
   200 fused training steps on the warm prefix, then ``replay`` (refresh
   every 2 steps with 40 tune steps, 8 requests of 64 users a step) into
   a capacity-padded fused-fp32 session with the launcher's caps. Labels
   and sketch digests must equal ``STREAM_REFERENCE`` (the JAX package's
   replay) at every step; every swap must allocate no device state (no
   capacity bump, every state tensor's ``data_ptr`` kept); the padded
   session's top-k must equal a fresh unpadded session's over the final
   artifact; its int8 quantization is swapped into a padded fused and a
   padded dense session, which must agree. Launch counts are zeroed just
   before the replay and read just after; codebook_lookup, the weighted
   CSR gather-sum and fused_topk must have run. It prints a ``stream``
   JSON line.
   Then the serving front end (``repro_torch.frontdoor``) over the
   trained export, as ``python -m repro_torch.launch.load_bench`` sets
   it up: ``web`` alone on a capacity-padded fused fp32 session,
   ``mobile`` and ``beta`` on one fused int8 session over its
   quantization, buckets (1, 8, 64), ``flush_ms`` 2, a 256-deep queue
   that sheds, a 1,024-entry hot-user cache. v2 is the main path's
   trainer fine-tuned 40 more steps and shipped as a verified delta.
   Two open-loop runs of 4 s on fresh tenants, at 120 and at 600 qps
   offered (bursts 2x, Zipf 1.1 users, sizes 1-8, tenant weights 0.5 /
   0.3 / 0.2), ``web`` swapping to v2 halfway. Launch counts are zeroed
   just before each run and read just after; codebook_lookup, the
   weighted CSR gather-sum and fused_topk must have run. Every arrival
   must be accounted for (responses + shed + timeouts + failed ==
   offered, no failure, no shed at 120 qps); every device batch, at its
   own padded bucket, and every response must equal a fresh session of
   the version that served it (bitwise or within ``topk_agree``'s
   near-ties); each ``web`` response must be wholly v1 or wholly v2, v2
   if submitted after the swap returned and v1 if resolved before it
   began; the swap must be ``swapped`` and allocate no device state
   across the registry. The change in the caching allocator's segments
   over each run is printed, not gated. It prints a ``frontdoor`` JSON
   line.
   Then the cluster build at scale (``repro_torch.launch.cluster_scale``:
   ``planted_coclusters`` at average degree 8, gamma 0.5, 8 sweeps). The
   100k rung (80,000 x 20,000, 286,695 edges): the streamed solve at
   ``block_edges`` 1<<20 and 1<<12, the in-memory solve and
   ``torch_hostloop``; the 1M rung (800,000 x 200,000, 2,647,670 edges):
   streamed at 1<<20 and 1<<14 (an oversized block for the item of
   degree 21,974), then in memory. Every solve of a rung gives the same
   labels and sweeps, equal to ``SCALE_REFERENCE`` (the JAX package's
   CPU solve); the streamed solves run on a graph no in-memory solve has
   touched, and at the smaller block size their peak device bytes (from
   a reset peak) must lie below the in-memory solve's. The minhash
   cold-assign experiment runs at 100k. Launch counts are zeroed just
   before the first solve and read just after the last; the CSR
   gather-sum (the ordered W(k) sums) must have run; the W(k) sums of
   each rung's final labels are then held bitwise against their plain
   version and timed. It prints a ``scale`` JSON line.
   Then the paper's comparison on the main path's graph (budget 0.25 x
   nodes): the ``random``, ``frequency``, ``double``, ``hybrid``, ``lsh``,
   ``lp`` and ``lpab`` sketches (``lp``/``lpab`` on the GPU solver, equal
   to the CPU port's at gowalla_s), their K and parameters against full;
   ``double`` (2-hot on both sides) trained 200 fused steps (batch
   2,048), Recall/NDCG@20 on 4,096 test users beside BACO's, exported,
   ``n_params``/``serving_nbytes`` in fp32 and int8 (int8 smaller), 13
   fused requests bitwise a fresh session's; launch counts around the
   training and the serving (codebook_lookup with items H = 2, the CSR
   gather-sum, fused_topk must run); the items' H = 2 lookup held
   against its plain version and timed; then CCE (``training/cce.py``)
   at beauty (22,363 x 12,101, budget 0.25 x nodes, 400 steps after 100
   warm ones, the k-means on the host) beside BACO in the same protocol,
   codebook_lookup and the CSR gather-sum launched, and at gowalla_s the
   card's CCE against the CPU's (the reclustered sketch equal, Recall@20
   within ``CCE_RECALL_TOL``). It prints a ``baselines`` JSON line.
   Then the recsys architectures at their full published width
   (``ARCH_CELLS``; params from their init under ``torch.Generator``
   seed 0, each compressed field's sketch a seeded random assignment
   into its codebook, ids uniform over each field's vocabulary):
   ``dlrm-mlperf-baco`` (24.1 GB of codebooks and tables, 0.75 GB of
   sketches) through ``ArchSession`` at ``serve_p99`` (B 512, 20
   requests), ``serve_bulk`` (B 262,144, 5) and ``retrieval_cand`` (C
   1,000,000, 5); ``wide-deep-baco`` at ``serve_p99`` and
   ``train_batch`` (B 65,536, 5 AdamW steps through ``build_cell``);
   ``sasrec-baco`` at ``serve_p99`` and ``train_batch``;
   ``bert4rec-baco`` at ``serve_p99``; each after one untimed warm-up.
   Launch counts are zeroed just before each cell and read just after;
   codebook_lookup, dot_interaction (DLRM), flash_attention on its
   CUDA-core route (SASRec, BERT4Rec) and, in the train cells, the CSR
   gather-sum must have run. The warm-up's first call of each kernel is
   held against its plain version on the very tensors the path passed
   (codebook_lookup and the CSR gather-sum bitwise, the others at the
   f32 tolerance below) and timed, with the counters restored after.
   Scores must have the expected shape and be finite, train losses
   finite, every param changed. Each cell's p50/p99 ms and peak device
   bytes (from a reset at its start, and from a reset after the warm-up)
   are printed; the device is freed between cells. The smoke cells of
   each arch then run on the card against the port's CPU path (rtol
   1e-4 / atol 1e-5). It prints an ``arch`` JSON line.
   Then the dense LM family at its published widths, each cell cut to one
   card (``launch.steps.LM_ONE_CARD``; params from ``init_params`` under
   generator seed 0, bf16; tokens uniform over the vocabulary; a decode
   cell's cache drawn standard normal in the cache dtype at ``pos =
   seq_len - 1``, so every step reads the full 32k cache) through
   ``ArchSession`` (``LM_CELLS``): ``prefill_32k`` of gemma2-9b and
   gemma3-12b (B 1 of 32, all their layers) and of qwen1.5-32b (B 1, 32
   of its 64 layers, fp8 cache), 2 requests each; ``decode_32k`` of
   gemma2-9b (B 4 of 128), gemma3-12b (B 8) and qwen1.5-32b (B 2, 32
   layers), each after one untimed warm-up whose token lookup
   (codebook_lookup's bf16 instantiation, at H = 1) is held bitwise
   against its plain version and timed (``first_calls``). Launch counts
   are zeroed just before each cell and read just after; the lookup must
   launch once a request. Logits must be finite f32 [B, vocab], and a
   prefill's cache finite (``finite_cache``). p50/p99,
   tokens/s and peak device bytes (from a reset after the warm-up) are
   printed, and each decode cell's arch runs the decode-after-prefill
   check on its full-width params (``lm_decode_after_prefill``: 64
   prompt tokens, 8 rows; tolerance by cache dtype, and two planted
   position faults that must fail it). bf16 GEMMs sum in
   f32: the model's entries turn cuBLAS's reduced-precision reduction off.
   Then the dense LMs' ``train_4k`` at full width through ``build_cell``
   at their one-card cuts (``LM_TRAIN_CELLS``; 8 sequences of 4,096
   tokens, one a microbatch): gemma2-9b at 8 of 42 layers and gemma3-12b
   at 6 of 48 (one 5:1 local:global block) with the f32 gradient
   accumulator, one timed step each; qwen1.5-32b at 5 of 64 with the
   bf16 one, 2 timed steps; each after one warm-up step on a fixed
   batch; the token lookup and the bf16 CSR gather-sum (its backward)
   must launch once a microbatch, the loss must be finite and fall at
   every step, and the peak must leave 15% of the card free; the
   warm-up's first lookup and first backward call are held bitwise
   against their plain versions and timed beside ``index_add_`` into
   f32 once the cell is freed. The smoke cells
   (f32, bf16 variants of gemma2's and qwen's prefill, and one bf16
   train step of each LM: loss rtol 1e-2, gradients within 8 bf16 ulps
   of max |g|) then run on the card against the port's CPU path. It
   prints an ``lm`` JSON line.
   Then the LM cells over a mesh (``lm_mesh``): an NCCL world of 1 under
   ``launch.mesh.make_host_mesh()``, each cell through ``build_cell(...,
   mesh=...)`` at the lm phase's one-card cut beside its unsharded twin
   on the same params and inputs, on the reference's data-axis layouts
   (the data axis has one rank, so every block is whole and no
   collective is issued): gemma2-9b decode_32k (B 4; the tensor-
   parallel path, params ZeRO'd over "data") and dbrx-132b decode_32k
   (8 layers, B 8; the expert-parallel path, ZeRO'd), one warm-up and
   ``n`` timed calls each, logits and the
   cache slots the step writes bitwise the twin's; one dbrx-132b
   train_4k step (1 layer, 8 x 4,096; the backward through the tensor-
   and expert-parallel Functions; FSDP by the rule at 1 layer, so its
   params split over "data" and its accumulator bf16), its loss and a
   digest of every updated param bitwise the twin's (each cell drawn
   afresh from seed 0); one train step of kimi-k2's smoke config at
   128 experts (``LM_MESH_ADAFACTOR_EXPERTS``: the reference's
   Adafactor route, over the experts' model axis) beside its twin, loss
   and params bitwise, codebook_lookup and the CSR gather-sum launched;
   one ``build_pp_train_cell`` step of qwen1.5-32b at train_4k's
   sequence (1 stage, 8 microbatches of one sequence; its depth
   reckoned against 85% of the card, ``lm_pp_layers``) against the
   microbatched one-card step at the same cut: loss within rtol 1e-5,
   at most 1% of the params different, each by at most 2 lr + 2^-7 |p|
   (the pipeline sums each param's gradient over the microbatches in
   bf16, the one-card step in f32; ``tests/test_torch_mesh.py`` holds the
   same bound on the CPU). Counts are zeroed just before each mesh run
   and read just after: the token lookup once a call or microbatch, the
   bf16 CSR gather-sum as the one-card cells run it; the collectives
   and the bytes they move a call or step are printed, and no cell may
   issue more than the run before did (``LM_MESH_COLLECTIVES_CAP``). Each
   cell's FSDP decision, accumulator dtype and count of params stored
   split over data are printed. It prints an ``lm_mesh`` JSON line; its
   launches count into the kernels line.
   Then the recsys, cf and GNN cells over a mesh (``arch_mesh``): an NCCL
   world of 1 under ``make_host_mesh()``, each cell of
   ``ARCH_MESH_CELLS`` through ``build_cell(..., mesh=...)`` at full
   published width, built from its one-card twin's args (the tables,
   sketches and batch the same tensors; a train cell's params cloned,
   so each steps its own copy): dlrm-mlperf-baco serve_p99 (47,036,416
   rows a field's table and sketch by "vocab" rows: the two-level
   row-sharded lookup, codebook_lookup and dot_interaction),
   wide-deep-baco train_batch (B 65,536: the lookups' backward into
   row blocks, the CSR gather-sum), sasrec-baco train_batch
   (flash_attention on the rank's rows), lightgcn-baco bpr_train
   (amazonbook width: the propagation's weighted CSR gather-sum over
   the rank's edge block) and schnet minibatch_lg. Gates: the first
   call's output (a train step's loss and every updated param) bitwise
   the twin's, its launches (by kernel, route and form) equal the
   twin's, peak memory under 85% of the card, and the four kernels run.
   A world of 1 holds every row in the one block, so the block lookup's
   masking is held apart (``ARCH_BLOCK_CHECKS``): at the DLRM serve_p99
   and W&D train_batch shapes, the middle half of a field's table as a
   block at lo > 0, ids over the whole table (inside and outside it),
   the rows and the block's gradient bitwise the "gather" backend's.
   It prints each cell's collectives and bytes a call, the median ms
   beside the twin's and the phase's seconds, then the reckoning of the
   cells no single card holds (``ARCH_NOT_RUN``: dlrm-mlperf serve and
   train, dlrm-mlperf-baco and bert4rec-baco train) by
   ``launch.steps.rank_bytes`` on one card and on 4 and 8 ranks. It
   prints an ``arch_mesh`` JSON line; its launches count into the
   kernels line.
   Then the dry run (``dryrun``): ``launch.dryrun`` over every cell on
   the (16, 16) and (2, 16, 16) meshes (``--all --both-meshes
   --include-variants --args-only``: the compiled half takes ~9 min on
   the CPU and runs there), in this process on meta tensors; it must
   record no failure and allocate nothing on the card. It prints a
   ``dryrun`` JSON line: the counts and the GB a rank of every LM cell
   (the port's layouts beside the reference's); the lm phase's
   ``lm_not_run`` prints kimi-k2 train_4k's from it.
   Then the op analysis (``op_analysis``): four one-card steps that
   other phases build (``OP_STEPS``: lightgcn-baco bpr_train at
   amazonbook width, dlrm-mlperf-baco serve_p99, dbrx-132b train_4k at 1
   layer, gemma2-9b decode_32k at B 4), each after a warm-up run once
   under ``launch.op_analysis.OpAnalysis`` on the card, timed (CUDA
   events, median), and reckoned on meta tensors
   (``launch.dryrun.reckon``, the same cut, no world): dot FLOPs by
   dtype, HBM bytes, kernel calls by name and host reads must be equal,
   the reckoned temporaries within ``OP_TEMP_RTOL`` / ``OP_TEMP_ATOL`` of
   the caching allocator's peak over the counted step. It prints an
   ``op_analysis`` JSON line: each step's ms beside the three roofline
   terms (``launch.roofline.terms_s``, the H100's published peaks) and
   ``bound_frac_of_measured`` (the largest term over the measured ms), with
   ``nvidia-smi``'s name and power limit.
   Then SchNet (``gnn``) at its published widths (d_hidden 64, 300 RBF,
   3 blocks, cutoff 10) through ``build_cell`` (``GNN_CELLS``):
   ``full_graph_sm`` (2,708 nodes, d_feat 1,433), ``minibatch_lg`` (a
   batch of the neighbor sampler over a Reddit-sized graph, 1,024 seeds,
   fanout (15, 10)), ``molecule`` (128 graphs of 30 atoms, the atom
   embedding through codebook_lookup) and ``ogb_products`` (2,449,029
   nodes, 1/8 of its edges: ``GNN_ONE_CARD``), each one warm-up and 3
   timed AdamW steps, one more step profiled. Counts zeroed just before
   each cell and read just after: the CSR gather-sum must launch twice
   a block (molecule: twice more), codebook_lookup once a step in
   molecule; losses finite; peaks leave 15% of the card free. Each
   cell's first segment sum and first gather gradient (and molecule's
   atom lookup and its gradient) as the model called them are held
   bitwise against the plain version and timed beside their bound and
   ``index_add_``. The smoke cells then run on the card against the CPU path (loss and every
   gradient, rtol 1e-4 / atol 1e-5). It prints a ``gnn`` JSON line.
3. Drives the embedding layer's entry points (``repro_torch.embedding``) at
   the same width, on the main path's sketch (K_u 8,878 with H=2, K_v 17,136
   with H=1) and its trained d=64 codebooks: the codebook
   readout ``fused_topk(sketch=...)`` over items and users (B 1..512, f32
   and int8, mask, exclusions from the training edges), every user's bag of
   training items (sum and mean, forward and backward; also in a random
   order, with no sortedness declared), and the gradient of
   the base embeddings through the "cuda" backend, twice, against the
   "gather" backend. Its kernels' launch counts are zeroed just before and
   read just after; each must have run.
4. Drives the path of DLRM's dot interaction and flash attention, the
   port's kernel bench (``repro_torch.launch.kernel_bench``): ``run(fast=
   False)`` (the four classic ops at the bench's full shapes, with the
   attention's max error against ``ref.mha``) and its JSON sweep (every
   lookup backend, the fused scorer against the dense path), plus one
   bf16 qwen1.5-32b layer (H 40, S 4,096, d 128) through
   ``ops.flash_attention``. Launch counts are zeroed just before and read
   just after; both kernels, and both of flash_attention's routes (f32 on
   the CUDA cores, bf16 on the tensor cores), must have run.
5. Holds each kernel against its plain PyTorch version on the card, at the
   paths' shapes and on edge cases (exact on integer-valued inputs, NaN
   scores), and times kernel, plain version and one PyTorch library call.
   dot_interaction at dlrm-mlperf's width (F 27, d 128) and its training
   batch (B 65,536), f32 and bf16, and at B 2,048 and 512; flash_attention
   at one layer of qwen1.5-32b (H 40, d 128) at S 4,096, bf16, causal, and
   at the bench's full shape (B 2, H 8, S 2,048, d 128, f32, causal and
   not), and checks that each shape ran the route its dtype and d choose
   (tensor cores for bf16/f16 at d <= 128). The kernels line's entries of
   codebook_lookup, the CSR gather-sum, dot_interaction and flash_attention
   add the arch phase's recorded calls (``arch_path``) and launches;
   dot_interaction's and flash_attention's lead rows are their
   ``ARCH_MAIN`` cells' calls. fused_topk is also held at k 33, 64, 100 and
   128 (exact on integer inputs) and timed at k 100; k 129 must be refused.
   Tolerances: f32 rtol 2e-4 / atol 2e-5; bf16 and f16 one rounding step
   of the type (rtol 1.5 x its eps, atol 1e-4); dot_interaction bitwise
   on integer inputs. Bounds
   charge products of two bf16 or f16 values at the bf16/f16 tensor rate
   and all other operations at the f32 rate; the 16-bit attention rows
   count every product at the tensor rate (their P·V runs on the tensor
   cores). fused_topk and its codebook variant also repeat bitwise over
   two calls. The CSR gather-sum (embedding_bag) is held bitwise and
   timed at the bag forward, the bag backward and both codebook
   gradients (``backward`` in its entry), and on skewed bags (4,000
   values beside 0-3-value and empty bags) at d 1..600; its weighted
   instantiation (the LightGCN propagation, ``weighted`` in its entry)
   bitwise at the propagation's two shapes, through ``_Propagate``
   forward and backward, and on edge cases (zero, -0.0 and negative
   weights, skewed bags, one row of 100,000 values), timed beside
   ``index_add_`` and the previous cumsum route; codebook_lookup
   at H 1..5 and 40, d 1..129, on unaligned codebooks, and its bf16 and
   f16 instantiations at d 1..3,584. Every timing
   enqueues a ~0.1 ms device spin before its start event, so it times
   the device and not the host's enqueue; the timer's floor (a
   one-element add) is printed once.
6. Profiles a few requests (device time per kernel, idle share), and checks
   the port end to end on a small input against itself on the CPU,
   serving and 20 training steps (losses to rtol 1e-5).
7. The benches (``repro_torch.launch``), each ``main(argv)`` as a user
   calls it, into a fresh results store in a temporary directory (never
   the default root), in ``BENCH_ARGS``: ``train_bench`` (amazonbook, d
   64, batch 2,048: host_seed, host, fused at chunks 1/8/32; 5 rounds),
   ``serve_bench`` (amazonbook, d 64: every lookup backend x both
   scorers x buckets 1/8/64, 100 requests a row), ``stream_bench``
   (52,643 x 91,599, k_true 300, d 64, 16 steps: 16 swaps),
   ``load_bench`` (amazonbook, d 64, 120 qps for 4 s), ``cluster_scale
   --rungs 100k`` and ``kernel_bench --json --repeats 100``. Each must
   append exactly one record keyed to this card
   (``gpu:<name>:1:torch<ver>:<limit>W``) with every metric's direction
   declared, and no error row; a row refused by a kernel's declared cap
   fails the phase (``refused_rows`` must be 0: the kernel bench's k =
   100 fused rows are measured); launch counts are zeroed before each
   bench and read after it, and codebook_lookup, fused_topk, its
   codebook variant and the CSR gather-sum must have run. The kernel
   bench is then called again (a cache hit: no record) and with
   ``--force`` (one record); ``roofline --serving store`` derives the
   fused sweep's bounds (bytes at 3.35 TB/s, operations at 67 TFLOP/s)
   and shares; ``train_bench --trace --profile`` (``PROFILE_ARGS``, not
   stored) must export a Chrome trace holding the codebook_lookup and CSR
   gather-sum kernels and the ``fit_gamma`` / ``cluster_solve``
   ``record_function`` ranges, and a span trace whose ``obs_report``
   rollup holds ``cluster_solve`` under ``fit_gamma``; ``bench_summary
   --check`` on the store prints its verdicts (a warning fails nothing,
   an exception or an undeclared direction does). It prints a
   ``benches`` JSON line.
8. The paper's experiments (``repro_torch.launch.paper``, ``paper_path``):
   four of the suite's modules (``PAPER_MODULES``: Figures 2 and 4,
   Tables 4 and 6) at ``--fast`` on the card, as ``python -m
   repro_torch.launch.paper.run`` runs them, in this process through
   ``main(argv, modules=...)`` into a fresh store (Figures 1 and 3 and
   Tables 5, 9 and 11 run on the card through ``tools/paper_full.py``).
   Every experiment runs at d 64 on the reference's datasets
   (gowalla_s); the trainings are LightGCN + BPR through ``Trainer``
   (codebook_lookup, the weighted and plain CSR gather-sums). Gates:
   exit 0 and no module ``FAILED``; one record a module keyed to this
   card with every metric's direction declared; every row's numbers
   finite; codebook_lookup and the CSR gather-sum launched over the
   suite (counts zeroed just before, read just after); table4's BACO at
   most 0.25 x the full model's params.
   Then fig2's ``bench(fast=False)`` (the solve sweep up to the
   84,000-node graph and its gamma grid searched three ways: the three
   must select one gamma), and fig4's label count at each of its 8
   iterations on the card equal to the CPU port's. It prints a
   ``paper`` JSON line: each module's seconds, table4's Recall, NDCG@20
   and params a method, fig2's build seconds a method and its full-size
   records, fig4's counts and the launches.

Prints a ``stream`` JSON line, a ``frontdoor`` JSON line, a ``scale``,
a ``baselines``, an ``arch``, an ``lm``, an ``lm_mesh``, an ``arch_mesh``,
a ``dryrun``, an ``op_analysis`` and a ``gnn`` JSON line, a
``kernels`` JSON line (the CSR gather-sum's bf16 instantiation has an
entry of its own), a ``timer`` line
(the timer's floor), a ``benches`` and a ``paper`` JSON line, the
``nvidia-smi``
name/power line, and as its last
line ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, if there is no CUDA device, if ``repro_torch`` is missing, or if any
phase fails. It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# each kernel's bound: its call's bytes and operations from
# repro_torch.kernels.cost (the same numbers launch.op_analysis reckons a
# step with) at the H100 SXM's published peaks (NVIDIA data sheet, dense)
# the JAX package's values on this dataset and seed (CPU run)
JAX_REFERENCE = {"k_users": 8878, "k_items": 17136, "gamma": 0.0078125,
                 "iters": 1}

# the frontdoor phase: 4 s open-loop runs at the reference load bench's
# 120 qps (no request may be shed) and at 600 qps
FRONTDOOR_RATES = (120.0, 600.0)
FRONTDOOR_DURATION_S = 4.0

# the stream phase's stream (amazonbook's users, items and k_true)
STREAM_ARGS = dict(n_users=52_643, n_items=91_599, k_true=300, avg_deg=10,
                   T=4, drift=0.05, seed=0)
# the JAX package's update-only replay of that stream on the CPU,
# pinned with `PYTHONPATH=src python tests/test_torch_stream.py`
# (``reference_stream_pins``: BACO d 64 ratio 0.25 on the warm prefix,
# then replay(updater, stream.steps, None, ReplayConfig(refresh_every=2,
# tune_steps=0)) with the launcher's caps): per step, adopted cold users
# and items, refresh sweeps and gamma, K_u and K_v, and the sha256 (its
# first 32 hex digits) of the labels and the sketch's index arrays
STREAM_REFERENCE = {
    "stream": {"n_warm_users": 31586, "n_warm_items": 54959,
               "base_edges": 118843, "total_edges": 514160},
    "bootstrap": {
        "k_users": 11364, "k_items": 30445, "gamma": 16.0,
        "iters": 5,
        "labels": "8b1ea76e3f0438ca034698d9220c682e",
        "user_idx": "7d22326e586a3f98389bcc214f71615f",
        "item_idx": "461dd194eeabcf0fe733d79650d3898d"},
    "steps": [
        {"adopted_users": 5264, "adopted_items": 8335,
         "k_users": 12647, "k_items": 31276,
         "labels": "e7b6a24e5c13c4c3b68fb8f65c626d6d",
         "user_idx": "7f268a8413f68e715e57d95b10c0bf39",
         "item_idx": "81c0effd2e715318b84ef63411ad145c"},
        {"adopted_users": 5264, "adopted_items": 8187, "sweeps": 7,
         "gamma": 16.0,
         "k_users": 14441, "k_items": 32268,
         "labels": "c26dad8b20105f71e4085c38f3d2b75b",
         "user_idx": "6b085c66bdacadb2a1656b1e3deea6cb",
         "item_idx": "149e8840fabda50262559032571f677e"},
        {"adopted_users": 5264, "adopted_items": 8214,
         "k_users": 15647, "k_items": 33221,
         "labels": "50b6a089c4802e7826da0a9a2d73248e",
         "user_idx": "c7e6b6ad1ae77d4083bb3c81d951d94d",
         "item_idx": "9fc12f5d420794490e7dd6b9f61db426"},
        {"adopted_users": 5265, "adopted_items": 8269, "sweeps": 7,
         "gamma": 16.0,
         "k_users": 16987, "k_items": 34131,
         "labels": "373cee0574b7bd28f440d471e073c231",
         "user_idx": "010aa68781356831971bcfb6f85e74f1",
         "item_idx": "3f89b06a4ea2f1057fc212898d4bab2a"},
    ]}


# the scale phase: the reference's in-memory solve (gamma 0.5, 8 sweeps)
# of the cluster-scale ladder's rungs on the CPU, pinned with
# `PYTHONPATH=src python tests/test_torch_scale.py`: edges, the sha256 (its
# first 32 hex digits) of the int32 labels, sweeps and Barber modularity
SCALE_REFERENCE = {
    "100k": {"n_edges": 286695, "labels": "cbfa03236c3d9dcdd8901fe0b02904ef",
             "iters": 8, "modularity": 0.6553885850996158},
    "1m": {"n_edges": 2647670, "labels": "9a490abd9bd75e2482de03d1b582ef50",
           "iters": 8, "modularity": 0.6298310676219552},
}
# streamed block sizes per rung; 1<<14 at 1M forces an oversized block for
# the item of degree 21,974
SCALE_BLOCKS = {"100k": (1 << 20, 1 << 12), "1m": (1 << 20, 1 << 14)}
# the baselines phase: the hashing, LSH and LP sketches built at full
# amazonbook width, and the 2-hot one trained, exported and served
# CCE (training/cce.py) at the smallest paper-sized dataset, in table 4's
# protocol (400 steps after 100 warm ones, batch 2,048, lr 5e-3), and
# the card-vs-CPU check at gowalla_s: 48 steps after 16 warm ones, its
# Recall@20 within the spread of the CPU port's seeds 0, 1 and 2 there
# (0.11944, 0.11919, 0.11695: `python tests/test_torch_cce.py`), and the
# reclustered sketch equal to the CPU port's
CCE_DATASET = "beauty"
CCE_STEPS = dict(steps=400, warm_steps=100)
CCE_CHECK = dict(steps=48, warm_steps=16)
CCE_RECALL_TOL = 0.0025
BASELINE_METHODS = ("random", "frequency", "double", "hybrid", "lsh", "lp",
                    "lpab")
BASELINE_TRAIN_STEPS = 200
# the benches phase: each bench CLI at the main path's width (amazonbook,
# d 64, training batch 2,048); the stream bench at the stream phase's
# 52,643 x 91,599 with k_true 300; one rate of 120 qps for 4 s; the 100k
# rung. Departures from the reference benches' defaults, so that each
# tail and each gated time rests on enough samples: 100 requests a
# serving row (the reference's 20 make p99 the largest of 20), a stream
# of 16 steps (16 swaps and 15 warm cold-assigns, not 4 and 3) at a drift
# of 0.0064 a step (half the share of users moved over the stream as 4
# steps at 0.05) and 100 calls a kernel-sweep row (not 3); the
# reference's 5 interleaved training rounds (the smoke ran 200 requests
# a row, 32 stream steps and 10 rounds until its LM cells needed the
# time: the onehot backend's rows take ~40 ms a request).
BENCH_ARGS = {
    "train_pipeline": ("train_bench", ["--dataset", "amazonbook", "--dim",
                                       "64", "--batch", "2048", "--rounds",
                                       "5"]),
    "serve_session": ("serve_bench", ["--dataset", "amazonbook", "--dim",
                                      "64", "--n-requests", "100"]),
    "stream": ("stream_bench", ["--n-users", "52643", "--n-items", "91599",
                                "--k-true", "300", "--dim", "64", "--steps",
                                "16", "--drift", "0.0064"]),
    "server": ("load_bench", ["--dataset", "amazonbook", "--dim", "64",
                              "--qps", "120", "--duration", "4"]),
    "cluster_scale": ("cluster_scale", ["--rungs", "100k"]),
    "kernel": ("kernel_bench", ["--json", "--repeats", "100"]),
}
# the columns of the train and serve benches' rows the benches line keeps
BENCH_ROW_KEYS = {
    "train_pipeline": ("backend", "chunk", "steps_per_s", "speedup_vs_seed"),
    "serve_session": ("backend", "scorer", "bucket", "p50_ms", "p99_ms",
                      "state_allocations"),
}
# the traced and profiled train bench: amazonbook width, one round of 4
# steps a backend (a trace of every step of the sweep would be several
# times larger)
PROFILE_ARGS = ["--dataset", "amazonbook", "--dim", "64", "--batch", "2048",
                "--steps", "4", "--rounds", "1"]


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing helpers (CUDA events, L2 flushed before every launch)
# ---------------------------------------------------------------------------
_SPIN = {}


def spin_cycles(us: float = 100.0) -> int:
    """Cycles of ``torch.cuda._sleep`` that keep the card busy for about
    ``us`` microseconds (calibrated once per process with CUDA events)."""
    import torch
    if "per_us" not in _SPIN:
        cycles = 1_000_000
        torch.cuda._sleep(cycles)                 # warm-up
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        torch.cuda.synchronize()
        _SPIN["per_us"] = cycles / (a.elapsed_time(b) * 1e3)
    return int(us * _SPIN["per_us"])


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms over ``iters`` launches, each
    started with a cold L2 (a 64 MB buffer is rewritten before it). A
    ~0.1 ms device spin sits between the flush and the start event, so
    the card is still busy while the host enqueues ``fn``'s work: the
    events time the device, not the host's enqueue."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    spin = spin_cycles()
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(spin)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        times.append((a, b))
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in times)
    return ms[len(ms) // 2]


def timer_floor_ms() -> float:
    """:func:`time_ms` around a one-element add: the least time it can
    report for one launch."""
    import torch
    x = torch.zeros(1, device="cuda")
    return time_ms(lambda: x.add_(1.0))


def pair_scorer(u, items, scale=None, mask=None):
    """score(rows, ids) -> (u[rows]·items[ids] + mask[ids], Σ|u·item|),
    both f64 numpy, computed on the card; int8 ``items`` dequantize
    through ``scale``. The second value is what the f32 rounding of the
    dot product scales with."""
    import torch

    def score(rows, ids):
        r = torch.as_tensor(rows, dtype=torch.long, device=u.device)
        c = torch.as_tensor(ids, dtype=torch.long, device=u.device)
        v = items[c].double()
        if scale is not None:
            v = v * scale[c].double()[:, None]
        p = u[r].double() * v
        s = p.sum(-1)
        if mask is not None:
            s = s + mask[c].double()
        return s.cpu().numpy(), p.abs().sum(-1).cpu().numpy()
    return score


def topk_agree(vals_a, ids_a, vals_b, ids_b, score, rtol=1e-5, atol=1e-6):
    """Top-k lists agree: each row's ids are distinct, values allclose,
    and wherever the ids differ the two values at that rank are a
    near-tie AND each list's id there really scores the value it was
    returned with (``score`` from ``pair_scorer``). Returns #differing
    ids."""
    import numpy as np
    va, vb = np.asarray(vals_a), np.asarray(vals_b)
    ia, ib = np.asarray(ids_a), np.asarray(ids_b)
    require(va.shape == vb.shape and ia.shape == ib.shape,
            f"top-k shapes differ: {va.shape} vs {vb.shape}")
    for ids in (ia, ib):
        srt = np.sort(ids, axis=1)
        require(not (srt[:, 1:] == srt[:, :-1]).any(),
                "an id repeats within a top-k row")
    require(np.allclose(va, vb, rtol=rtol, atol=atol),
            f"top-k values differ: max |diff| "
            f"{float(np.max(np.abs(va - vb)))}")
    diff = ia != ib
    if diff.any():
        tie = (va[diff] == vb[diff]) | (
            np.abs(va[diff] - vb[diff]) <= atol + rtol * np.abs(vb[diff]))
        require(tie.all(), "top-k ids differ beyond near-ties")
        rows = np.nonzero(diff)[0]
        for vals, ids in ((va, ia), (vb, ib)):
            want, size = score(rows, ids[diff])
            got = vals[diff]
            ok = (got == want) | (np.abs(got - want) <= atol + rtol * size)
            require(ok.all(), "a top-k id does not score the value returned "
                    "with it")
    return int(diff.sum())


# ---------------------------------------------------------------------------
# phase 2: the main path
# ---------------------------------------------------------------------------
def sync(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def counted_kernels() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches, by
    the name the ``kernels`` line gives the kernel."""
    from repro_torch.kernels import (codebook_lookup, csr_gather_sum,
                                     dot_interaction, flash_attention,
                                     fused_topk, fused_topk_codebook)
    return {"codebook_lookup": codebook_lookup, "fused_topk": fused_topk,
            "fused_topk_codebook": fused_topk_codebook,
            "embedding_bag": csr_gather_sum,
            "dot_interaction": dot_interaction,
            "flash_attention": flash_attention}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in counted_kernels().items()}


def zero_counts() -> None:
    for fn in counted_kernels().values():
        fn.launches = 0
    fa = counted_kernels()["flash_attention"]
    fa.launches_tc = fa.launches_cc = 0
    eb = counted_kernels()["embedding_bag"]
    eb.launches_weighted = eb.launches_16 = 0


def flash_routes() -> dict:
    """flash_attention's launches by route: tensor cores, CUDA cores."""
    fa = counted_kernels()["flash_attention"]
    return {"tc": fa.launches_tc, "cc": fa.launches_cc}


def main_path(workdir: str, dataset: str = "amazonbook",
              device: str = "cuda", train_steps: int = 600) -> dict:
    """The main path: BACO, training (:func:`train_path`), export, and
    serving the exported codebooks (``device="cpu"`` and a small dataset
    make a rehearsal of the same code on a machine without a GPU)."""
    import numpy as np
    import torch

    from repro_torch.core import ClusterEngine, make_weights
    from repro_torch.data import paperlike_dataset
    from repro_torch.embedding import dequantize_params
    from repro_torch.models import lightgcn as L
    from repro_torch.serve import (BatchDispatcher, CompressedArtifact,
                                   RecsysSession)

    t0 = time.perf_counter()
    _, _, _, train, test = paperlike_dataset(dataset, seed=0)
    t_data = time.perf_counter() - t0
    log(f"dataset {dataset}: {train.n_users} users, {train.n_items} items, "
        f"{train.n_edges} train edges ({t_data:.1f} s on the host)")

    zero_counts()

    engine = ClusterEngine(device=device)
    t0 = time.perf_counter()
    sketch = engine.build(train, d=64, ratio=0.25)
    sync(device)
    t_cluster = time.perf_counter() - t0
    build_stats = dict(engine.stats)        # the build's alone
    cluster_launches = launch_counts()["embedding_bag"]
    meta = sketch.meta
    got = {"k_users": sketch.k_users, "k_items": sketch.k_items,
           "gamma": meta["gamma"], "iters": meta["iters"]}
    log(f"cluster build: {t_cluster:.2f} s, sweeps={build_stats['sweeps']} "
        f"host_syncs={build_stats['host_syncs']}")
    log(f"cluster result  K_u={got['k_users']} K_v={got['k_items']} "
        f"gamma={got['gamma']} iters={got['iters']}")
    log(f"JAX reference   K_u={JAX_REFERENCE['k_users']} "
        f"K_v={JAX_REFERENCE['k_items']} gamma={JAX_REFERENCE['gamma']} "
        f"iters={JAX_REFERENCE['iters']} -> "
        f"{'match' if got == JAX_REFERENCE else 'MISMATCH'}")

    # two GPU solves of the selected gamma give identical labels
    wu, wv = make_weights(train, "hws")
    lab_a, it_a = engine.solve(train, wu, wv, meta["gamma"],
                               meta["eff_budget"])
    lab_b, it_b = engine.solve(train, wu, wv, meta["gamma"],
                               meta["eff_budget"])
    require(np.array_equal(lab_a, lab_b) and it_a == it_b,
            "two GPU solves gave different labels")
    log(f"determinism: two GPU solves at gamma={meta['gamma']} give "
        f"identical labels ({it_a} sweeps each)")

    trained = train_path(train, test, sketch, workdir, device,
                         steps=train_steps)
    art = trained["artifact"]
    t0 = time.perf_counter()
    loaded = CompressedArtifact.load(trained["path"])
    require(loaded.content_id() == art.content_id(),
            "artifact content_id changed across save/load")
    require(loaded.provenance.get("train_steps") == train_steps,
            "the served artifact is not the trained export")
    t_artifact = time.perf_counter() - t0
    log(f"serving the trained export {art.content_id()} "
        f"({t_artifact:.1f} s to load)")

    zero_counts()

    rng = np.random.default_rng(0)
    sizes = [1, 8, 64, 512] + [int(s) for s in rng.integers(1, 513, 9)]
    batches = [rng.integers(0, train.n_users, s) for s in sizes]
    outputs, serve, n_warmups = {}, {}, 0
    t0 = time.perf_counter()
    for quant in (False, True):
        src = loaded.quantize() if quant else loaded
        for scorer in ("fused", "dense"):
            session = RecsysSession.from_artifact(src, k=20, scorer=scorer,
                                                  device=device)
            disp = BatchDispatcher(session, (1, 8, 64, 512))
            disp.warmup()
            n_warmups += len(disp.buckets)
            outs, b512_ms = [], None
            for b in batches:
                t_req = time.perf_counter()
                outs.append(disp(b))
                if b.size == 512 and b512_ms is None:
                    b512_ms = (time.perf_counter() - t_req) * 1e3
            for vals, ids in outs:
                require(np.isfinite(vals).all(), "non-finite top-k values")
                require(ids.min() >= 0 and ids.max() < train.n_items,
                        "top-k ids out of range")
            name = f"{scorer}-{'int8' if quant else 'fp32'}"
            outputs[name] = outs
            st = disp.stats()
            serve[name] = {"requests": st["requests"],
                           "p50_ms": st["p50_ms"], "p99_ms": st["p99_ms"],
                           "b512_ms": b512_ms}
    sync(device)
    t_serve = time.perf_counter() - t0
    counts = launch_counts()
    launches = {name: counts[name]
                for name in ("codebook_lookup", "fused_topk", "embedding_bag")}
    n_requests = sum(v["requests"] for v in serve.values())
    # every session call, the dispatchers' warm-up calls included
    n_calls = n_requests + n_warmups
    weighted_per_request = weighted_launches() / n_calls
    log(f"served {n_requests} requests in {t_serve:.1f} s: {serve}")
    log(f"kernel launches on the serving path: {launches} (weighted CSR "
        f"gather-sum: {weighted_per_request:g} a request)")
    for name in launches:
        require(launches[name] > 0, f"{name} never ran on the serving path")
    for prec, src in (("fp32", loaded), ("int8", loaded.quantize())):
        params = {kk: torch.as_tensor(vv, device=device)
                  for kk, vv in src.serving_params().items()}
        statics = src.statics(torch.device(device))
        u_all, v_all = L.all_embeddings(dequantize_params(params), statics,
                                        src.mcfg())
        n_diff = 0
        for b, (vf, idf), (vd, idd) in zip(batches, outputs[f"fused-{prec}"],
                                           outputs[f"dense-{prec}"]):
            require(vf.shape == (idf.shape[0], 20), "bad top-k shape")
            score = pair_scorer(u_all[torch.as_tensor(b, device=device)],
                                v_all, mask=statics.get("item_mask"))
            n_diff += topk_agree(vf, idf, vd, idd, score)
        log(f"fused vs dense top-k ({prec}): agree, {n_diff} ids differ "
            f"at near-ties")

    return {"train": train, "test": test, "sketch": sketch,
            "loaded": loaded, "launches": launches, "serve": serve,
            "cluster_s": t_cluster, "cluster_launches": cluster_launches,
            "cluster": got, "stats": build_stats, "training": trained,
            "weighted_per_request": weighted_per_request}


def weighted_launches() -> int:
    from repro_torch.kernels import csr_gather_sum
    return csr_gather_sum.launches_weighted


def sync_free_chunk(trainer, n: int, device: str):
    """One fused chunk of ``n`` steps with every synchronizing call made
    an error (``torch.cuda.set_sync_debug_mode("error")``): the chunk
    only enqueues work. Returns its losses (host list)."""
    import torch
    if device != "cuda":
        return trainer.backend.chunk(trainer, n).tolist()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = trainer.backend.chunk(trainer, n)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return losses.tolist()


def train_path(train, test, sketch, workdir: str, device: str = "cuda",
               steps: int = 600, chunk: int = 16) -> dict:
    """LightGCN + BPR on the main path's sketch with the launcher's
    defaults (``python -m repro_torch.launch.train``: fused backend, batch
    2,048, lr 5e-3, seed 0, chunks of 16), Recall/NDCG@20 on the test
    split before and after (top-k by "block" and "fused"), one warm chunk
    under sync-debug "error", and the export the sessions then serve.
    Then, off the timed path: ``host`` with the device sampler bitwise
    equal to ``fused`` over 32 steps, and a kill at step 32 and resume
    from its checkpoint bitwise equal to 64 uninterrupted steps."""
    import math
    import statistics

    import torch

    from repro_torch.training import TrainConfig, Trainer

    cfg = TrainConfig(steps=steps, batch_size=2048, lr=5e-3, seed=0,
                      backend="fused", chunk_size=chunk)
    tr = Trainer(train, sketch, cfg, device=device)

    def evaluate():
        t0 = time.perf_counter()
        out = {b: tr.evaluate(test, max_users=4096, topk_backend=b)
               for b in ("block", "fused")}
        sync(device)
        require(abs(out["block"]["recall"] - out["fused"]["recall"]) <= 5e-3
                and abs(out["block"]["ndcg"] - out["fused"]["ndcg"]) <= 5e-3,
                f"block and fused top-k disagree on Recall/NDCG: {out}")
        return out, time.perf_counter() - t0

    untrained, _ = evaluate()
    log(f"untrained init_params(0) codebooks: {untrained}")

    zero_counts()
    sync(device)
    losses, per_step_ms = [], []
    t_train = time.perf_counter()
    while tr.step < steps:
        t0 = time.perf_counter()
        losses += tr.run(steps=min(tr.step + chunk, steps), log_every=0)
        per_step_ms.append((time.perf_counter() - t0) * 1e3 / chunk)
        if tr.step == chunk and steps >= 2 * chunk:
            losses += sync_free_chunk(tr, chunk, device)
            log(f"a warm chunk of {chunk} steps ran under sync-debug "
                f"'error': no host sync")
    sync(device)
    t_train = time.perf_counter() - t_train
    weighted_per_step = weighted_launches() / steps
    require(len(losses) == steps and all(math.isfinite(x) for x in losses),
            "training losses are not finite")
    require(losses[-1] < losses[0], f"the loss did not fall: {losses[0]} -> "
            f"{losses[-1]}")
    ms_step = statistics.median(per_step_ms[1:] or per_step_ms)
    trained, eval_s = evaluate()
    ratio = trained["block"]["recall"] / max(untrained["block"]["recall"],
                                             1e-12)
    log(f"trained {steps} steps in {t_train:.2f} s: {ms_step:.4f} ms a step "
        f"(median of chunks after the first), loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}; Recall/NDCG@20 {trained} ({eval_s:.2f} s); "
        f"recall {ratio:.3f}x the untrained codebooks'")
    require(trained["block"]["recall"] > untrained["block"]["recall"],
            "training did not raise Recall@20 above the untrained codebooks'")
    counts = launch_counts()
    launches = {n: counts[n] for n in ("codebook_lookup", "embedding_bag")}
    log(f"kernel launches on the training path: {launches} (weighted CSR "
        f"gather-sum: {weighted_per_step:g} a step)")
    for name in launches:
        require(launches[name] > 0, f"{name} never ran on the training path")
    path = os.path.join(workdir, "artifact")
    art = tr.export(path)

    # parity, off the timed path
    def tables(t):
        return {k: v.detach().clone() for k, v in t.params.items()}

    short = TrainConfig(steps=32, batch_size=2048, lr=5e-3, seed=0,
                        chunk_size=chunk, sampler="device")
    runs = {}
    for backend in ("host", "fused"):
        t = Trainer(train, sketch, dataclasses.replace(short, backend=backend),
                    device=device)
        runs[backend] = (t.run(log_every=0), tables(t))
    require(runs["host"][0] == runs["fused"][0] and all(
        torch.equal(runs["host"][1][k], v)
        for k, v in runs["fused"][1].items()),
        "fused is not bitwise the host backend with the device sampler")
    ck = dataclasses.replace(short, backend="fused", steps=64,
                             ckpt_every=32,
                             ckpt_dir=os.path.join(workdir, "ckpt"))
    whole = Trainer(train, sketch, dataclasses.replace(ck, ckpt_dir=None),
                    device=device)
    whole_losses = whole.run(log_every=0)
    killed = Trainer(train, sketch, ck, device=device)
    first = killed.run(steps=32, log_every=0)
    resumed = Trainer(train, sketch, ck, device=device)
    require(resumed.maybe_resume() and resumed.step == 32,
            "no checkpoint at step 32 to resume from")
    rest = resumed.run(log_every=0)
    require(first + rest == whole_losses and all(
        torch.equal(resumed.params[k], v) for k, v in tables(whole).items()),
        "kill and resume is not bitwise the uninterrupted run")
    log("parity: 32 steps of host (device sampler) bitwise equal to fused; "
        "kill at 32 and resume bitwise equal to 64 uninterrupted steps")
    prof = profile_chunk(whole, chunk) if device == "cuda" else None
    return {"artifact": art, "trainer": tr, "path": path, "steps": steps,
            "ms_per_step": ms_step, "ms_per_step_chunks": per_step_ms,
            "seconds": t_train, "loss_first": losses[0],
            "loss_last": losses[-1], "untrained": untrained,
            "trained": trained, "recall_ratio": ratio,
            "launches": launches, "weighted_per_step": weighted_per_step,
            "profile": prof}


# ---------------------------------------------------------------------------
# phase 2a: the main path over a torch.distributed world (NCCL, 1 rank)
# ---------------------------------------------------------------------------
SHARDED_STEPS = 64
SHARDED_CHUNK = 16


def compress_results(grads: dict, up: dict, device: str) -> dict:
    """``compress_decompress`` (bf16; int8 with the given ``up`` mask) and
    ``mean_grads_compressed`` (bf16, int8) under a "data" mesh over the
    current world, on ``device``; results on the host."""
    from repro_torch.distributed import data_mesh, use_mesh
    from repro_torch.training.compress import (compress_decompress,
                                               mean_grads_compressed)
    g = {k: v.to(device) for k, v in grads.items()}
    out = {"decompress bf16": compress_decompress(g, "bf16"),
           "decompress int8": compress_decompress(g, "int8", up=up)}
    with use_mesh(data_mesh(device=device)):
        for method in ("bf16", "int8"):
            out[f"mean {method}"] = mean_grads_compressed(g, method)
    return {name: {k: v.cpu() for k, v in r.items()}
            for name, r in out.items()}


def sharded_path(run: dict, device: str = "cuda",
                 steps: int = SHARDED_STEPS, chunk: int = SHARDED_CHUNK
                 ) -> dict:
    """The main path over a ``torch.distributed`` world of 1 (NCCL on the
    card, on a localhost store; destroyed when the phase ends, also when
    it fails): ``ClusterEngine(solver="torch_sharded",
    mesh=cluster_mesh())`` at amazonbook width must give the main path's
    sketch bitwise (indices, K, gamma) in as many sweeps; then
    ``fused_sharded`` and ``fused`` train from the same ``init_params``
    for ``steps`` steps in chunks of ``chunk``, interleaved chunk by
    chunk (which goes first alternates) and timed, each trainer's second
    chunk under sync-debug "error"; losses, params and the
    kernels' launches a step must be equal. Then ``training.compress`` on
    one of the trainer's gradients: every function on the card bitwise
    the same function on the CPU (a gloo world of 1 after the NCCL one).
    Launch counts are zeroed just before the sharded solve; the kernels
    line counts the solve's and the sharded trainer's launches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import ClusterEngine
    from repro_torch.distributed import cluster_mesh, world
    from repro_torch.training import TrainConfig, Trainer

    train, want = run["train"], run["sketch"]
    require(not dist.is_initialized(),
            "a process group is alive before the sharded phase")
    t_phase = time.perf_counter()
    with world(device) as dev:
        backend = dist.get_backend()
        zero_counts()
        engine = ClusterEngine(solver="torch_sharded",
                               mesh=cluster_mesh(device=dev), device=str(dev))
        t0 = time.perf_counter()
        sketch = engine.build(train, d=64, ratio=0.25)
        sync(device)
        t_build = time.perf_counter() - t0
        solve_launches = launch_counts()["embedding_bag"]
        same = (sketch.meta["solver"] == "torch_sharded"
                and np.array_equal(sketch.user_idx, want.user_idx)
                and np.array_equal(sketch.item_idx, want.item_idx)
                and (sketch.k_users, sketch.k_items, sketch.meta["gamma"])
                == (want.k_users, want.k_items, want.meta["gamma"])
                and engine.stats["sweeps"] == run["stats"]["sweeps"])
        require(same, "the torch_sharded sketch on a world of 1 is not the "
                "main path's")
        require(solve_launches > 0,
                "embedding_bag never ran in the torch_sharded solve")
        log(f"sharded ({backend}, world of {dist.get_world_size()}): "
            f"torch_sharded build {t_build:.2f} s, the main path's torch "
            f"build {run['cluster_s']:.2f} s; sketch bitwise equal "
            f"(K_u={sketch.k_users} K_v={sketch.k_items} gamma="
            f"{sketch.meta['gamma']}, {engine.stats['sweeps']} sweeps); "
            f"{solve_launches} CSR gather-sum launches (partial W(k))")

        cfg = TrainConfig(steps=steps, batch_size=2048, lr=5e-3, seed=0,
                          chunk_size=chunk)
        names = ("fused", "fused_sharded")
        trainers = {b: Trainer(train, want, dataclasses.replace(
            cfg, backend=b), device=dev) for b in names}
        losses = {b: [] for b in names}
        ms = {b: [] for b in names}
        launches = {b: {"codebook_lookup": 0, "embedding_bag": 0}
                    for b in names}
        for c in range(steps // chunk):
            for b in (names if c % 2 == 0 else names[::-1]):
                tr = trainers[b]
                sync(device)
                before = launch_counts()
                t0 = time.perf_counter()
                if c == 1:
                    out = sync_free_chunk(tr, chunk, device)
                else:
                    out = tr.backend.chunk(tr, chunk).tolist()
                ms[b].append((time.perf_counter() - t0) * 1e3 / chunk)
                losses[b] += out
                after = launch_counts()
                for k in launches[b]:
                    launches[b][k] += after[k] - before[k]
        sharded = trainers["fused_sharded"]
        require(all(math.isfinite(x) for x in losses["fused"])
                and losses["fused"] == losses["fused_sharded"],
                "fused_sharded losses on a world of 1 are not fused's")
        require(all(torch.equal(sharded.params[k], v)
                    for k, v in trainers["fused"].params.items()),
                "fused_sharded params on a world of 1 are not fused's")
        require(launches["fused"] == launches["fused_sharded"]
                and all(launches["fused"].values()),
                f"launches differ or are missing: {launches}")
        med = {b: statistics.median(ms[b][1:]) for b in names}
        log(f"sharded: {steps} steps of fused_sharded bitwise fused (losses "
            f"{losses['fused'][0]:.5f} -> {losses['fused'][-1]:.5f}); "
            f"median ms a step (chunks after the first, interleaved): "
            f"fused {med['fused']:.4f}, fused_sharded "
            f"{med['fused_sharded']:.4f}; {sharded.backend.allreduce_bytes}"
            f" bytes all-reduced a step; launches a step "
            f"{ {k: v / steps for k, v in launches['fused'].items()} }; "
            f"each trainer's second chunk ran under sync-debug 'error'")

        u, p, n = sharded.sampler.sample_fn(sharded.sampler.seed, steps)
        _, grads = sharded.loss_and_grads({"user": u, "pos": p, "neg": n})
        grads = {k: g.cpu() for k, g in zip(sorted(sharded.params), grads)}
        gen = torch.Generator().manual_seed(0)
        up = {k: torch.rand(g.shape, generator=gen) < 0.5
              for k, g in grads.items()}
        on_card = compress_results(grads, up, str(dev))
    require(not dist.is_initialized(), "the NCCL world outlived its phase")
    with world("cpu"):
        on_cpu = compress_results(grads, up, "cpu")
    require(not dist.is_initialized(), "the gloo world outlived its phase")
    for name, r in on_card.items():
        require(all(torch.equal(v, on_cpu[name][k]) for k, v in r.items()),
                f"compress: {name} on the card is not the CPU's")
    log(f"compress: {sorted(on_card)} on the card bitwise the CPU's, on "
        f"the gradients of {sorted(grads)}")
    seconds = time.perf_counter() - t_phase
    log(f"sharded phase: {seconds:.1f} s")
    return {"backend": backend, "world_size": 1, "seconds": seconds,
            "build_s": t_build, "main_build_s": run["cluster_s"],
            "sweeps": engine.stats["sweeps"],
            "ms_per_step": med, "ms_per_step_chunks": ms,
            "allreduce_bytes_per_step": sharded.backend.allreduce_bytes,
            "loss_first": losses["fused"][0],
            "loss_last": losses["fused"][-1],
            "launches_per_step": {k: v / steps
                                  for k, v in launches["fused"].items()},
            "compress_checked": sorted(on_card),
            "launches": {"codebook_lookup":
                         launches["fused_sharded"]["codebook_lookup"],
                         "embedding_bag": solve_launches
                         + launches["fused_sharded"]["embedding_bag"]}}


# ---------------------------------------------------------------------------
# phase 2b: the stream (cold-start assignment, refresh, deltas, hot swap)
# ---------------------------------------------------------------------------
def digest(a) -> str:
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:32]


def record_stream_steps(updater):
    """Wrap ``updater.apply_events``/``refresh`` so each replay step
    appends the entry ``STREAM_REFERENCE["steps"]`` pins to ``rec`` (its
    digests are filled in by :func:`close_stream_step` at the end of the
    step), and its cold-assign and refresh times and churn to
    ``timing``."""
    rec, timing = [], []
    apply_events, refresh = updater.apply_events, updater.refresh

    def apply_wrapped(*args):
        out = apply_events(*args)
        rec.append({"adopted_users": out["assign"].adopted_users,
                    "adopted_items": out["assign"].adopted_items})
        timing.append({"cold_assign_ms": out["assign"].ms})
        return out

    def refresh_wrapped(*args, **kwargs):
        stats = refresh(*args, **kwargs)
        rec[-1].update(sweeps=stats.iters, gamma=stats.gamma)
        timing[-1].update(refresh_ms=stats.ms, churn_users=stats.churn_users,
                          churn_items=stats.churn_items)
        return stats

    updater.apply_events = apply_wrapped
    updater.refresh = refresh_wrapped
    return rec, timing


def close_stream_step(rec: list, updater) -> None:
    rec[-1].update(k_users=updater.sketch.k_users,
                   k_items=updater.sketch.k_items,
                   labels=digest(updater.labels),
                   user_idx=digest(updater.sketch.user_idx),
                   item_idx=digest(updater.sketch.item_idx))


def state_ptrs(session) -> dict:
    return {f"{kind}/{k}": v.data_ptr()
            for kind, state in (("params", session.params),
                                ("statics", session.statics))
            for k, v in state.items()}


def stream_path(device: str = "cuda", stream_args=None, reference=None,
                bootstrap_steps: int = 200) -> dict:
    """The stream at full amazonbook width (``STREAM_ARGS``): BACO (d 64,
    ratio 0.25) and 200 fused training steps on the warm prefix, then
    ``replay`` of the stream's waves into a capacity-padded fused-fp32
    session (refresh every 2 steps, 40 tune steps, 8 requests of 64
    users a step) with the launcher's caps. Labels and sketch digests
    must equal ``STREAM_REFERENCE`` at every step (the JAX package's
    update-only replay; ``stream_args`` and ``reference`` replace both for
    a rehearsal at another size); swaps must allocate no device state;
    after the
    replay the int8 quantization of the final artifact is swapped into a
    padded fused and a padded dense session, which must agree, and the
    fp32 padded session must equal a fresh unpadded one."""
    import numpy as np
    import torch

    from repro_torch.core import ClusterEngine
    from repro_torch.data import drifting_coclusters
    from repro_torch.embedding import dequantize_params
    from repro_torch.models import lightgcn as L
    from repro_torch.stream import ReplayConfig, StreamUpdater, replay
    from repro_torch.training import TrainConfig, Trainer

    ref = reference or STREAM_REFERENCE
    args = dict(stream_args or STREAM_ARGS)
    t0 = time.perf_counter()
    stream = drifting_coclusters(**args)
    t_data = time.perf_counter() - t0
    n_edges = stream.base.n_edges + sum(s.edge_u.size for s in stream.steps)
    sizes = {"n_warm_users": stream.n_warm_users,
             "n_warm_items": stream.n_warm_items,
             "base_edges": stream.base.n_edges, "total_edges": n_edges}
    log(f"stream {args}: warm prefix {sizes}, {len(stream.steps)} waves to "
        f"{stream.n_users} x {stream.n_items} ({t_data:.1f} s on the host)")
    require(sizes == ref["stream"], f"the stream's sizes {sizes} are not "
            f"the reference's {ref['stream']}")

    engine = ClusterEngine(device=device)
    t0 = time.perf_counter()
    sketch = engine.build(stream.base, d=64, ratio=0.25)
    t_build = time.perf_counter() - t0
    boot = {"k_users": sketch.k_users, "k_items": sketch.k_items,
            "gamma": sketch.meta["gamma"], "iters": sketch.meta["iters"],
            "labels": digest(sketch.meta["joint_labels"]),
            "user_idx": digest(sketch.user_idx),
            "item_idx": digest(sketch.item_idx)}
    log(f"bootstrap BACO on the warm prefix: {t_build:.2f} s, "
        f"K_u={boot['k_users']} K_v={boot['k_items']} "
        f"gamma={boot['gamma']} iters={boot['iters']}")
    require(boot == ref["bootstrap"], f"the bootstrap sketch {boot} is not "
            f"the reference's {ref['bootstrap']}")
    tr = Trainer(stream.base, sketch,
                 TrainConfig(steps=bootstrap_steps, batch_size=2048,
                             lr=5e-3, seed=0, backend="fused",
                             chunk_size=16), device=device)
    t0 = time.perf_counter()
    losses = tr.run(log_every=0)
    sync(device)
    t_train = time.perf_counter() - t0
    log(f"bootstrap training: {bootstrap_steps} fused steps in "
        f"{t_train:.2f} s, loss {losses[0]:.5f} -> {losses[-1]:.5f}")

    caps = {"n_users": stream.n_users, "n_items": stream.n_items,
            "k_users": stream.n_users // 2, "k_items": stream.n_items // 2,
            "n_edges": n_edges}
    updater = StreamUpdater.from_trainer(tr, engine=engine, capacity=caps)
    art0 = tr.export()
    session = art0.session(k=20, capacity=caps, scorer="fused",
                           device=device)
    session.warmup(64)
    rungs = session.stats()["capacity"]
    log(f"capacity caps {caps} -> rungs {rungs} ({n_edges} stream edges)")
    alloc0, ptrs0 = session.state_allocations, state_ptrs(session)
    rec, timing = record_stream_steps(updater)
    cfg = ReplayConfig(refresh_every=2, tune_steps=40, requests_per_step=8,
                       request_batch=64)

    zero_counts()
    sync(device)
    t0 = time.perf_counter()
    report = replay(updater, stream.steps, session, cfg,
                    log=lambda line: (close_stream_step(rec, updater),
                                      log(f"  {line}")))
    sync(device)
    t_replay = time.perf_counter() - t0
    counts = launch_counts()
    launches = {n: counts[n] for n in ("codebook_lookup", "fused_topk",
                                       "embedding_bag")}
    weighted = weighted_launches()
    log(f"replay: {t_replay:.1f} s; kernel launches {launches} (weighted "
        f"CSR gather-sum {weighted})")
    for name in launches:
        require(launches[name] > 0, f"{name} never ran on the stream path")
    require(weighted > 0, "the weighted CSR gather-sum never ran on the "
            "stream path")
    tele = report["telemetry"]
    require(session.state_allocations == alloc0
            and state_ptrs(session) == ptrs0 and tele["capacity_bumps"] == 0,
            f"a swap allocated device state: "
            f"{session.state_allocations - alloc0} tensors, "
            f"{tele['capacity_bumps']} capacity bumps")
    log(f"{tele['swaps']} swaps allocated no device state (every params/"
        f"statics tensor kept its data_ptr); no capacity bump")
    for t, (got, want) in enumerate(zip(rec, ref["steps"])):
        require(got == want, f"stream step {t}: {got} is not the "
                f"reference's {want}")
    require(len(rec) == len(ref["steps"]), "replay step count differs")
    log(f"labels and sketch digests equal the reference's at all "
        f"{len(rec)} steps")

    # the final artifact: padded == fresh unpadded; int8 fused == dense
    final = report["final_artifact"]
    ids = np.arange(0, final.model["n_users"], 97)
    fresh = final.session(k=20, scorer="fused", device=device)
    got, want = session(ids), fresh(ids)
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            "the padded session's top-k is not the unpadded session's")
    quant = final.quantize()
    outs, swap_alloc = {}, 0
    for scorer in ("fused", "dense"):
        s = art0.quantize().session(k=20, capacity=caps, scorer=scorer,
                                    device=device)
        ptrs = state_ptrs(s)
        sw = s.swap(quant)
        swap_alloc += sw["state_allocations"]
        require(not sw["capacity_bumped"] and sw["state_allocations"] == 0
                and state_ptrs(s) == ptrs,
                f"the int8 swap into the {scorer} session allocated")
        outs[scorer] = [tuple(x.cpu() for x in s(ids))]
    params = {k: torch.as_tensor(v, device=device)
              for k, v in quant.serving_params().items()}
    statics = quant.statics(torch.device(device))
    u_all, v_all = L.all_embeddings(dequantize_params(params), statics,
                                    quant.mcfg())
    (vf, idf), (vd, idd) = outs["fused"][0], outs["dense"][0]
    n_diff = topk_agree(vf, idf, vd, idd, pair_scorer(
        u_all[torch.as_tensor(ids, device=device)], v_all))
    log(f"final artifact {final.content_id()}: padded fused fp32 == fresh "
        f"unpadded ({ids.size} users); int8 swapped into padded fused and "
        f"dense sessions with no allocation, agree ({n_diff} ids differ at "
        f"near-ties)")

    plain = check_stream_kernels(updater, session, ids[:64], device)

    swap = session.telemetry.swap
    st = session.stats()
    swap_ms = {"p50": swap.percentile(50), "max": swap.percentile(100)}
    lat = serve_padded_vs_unpadded(session, fresh, ids[:64], device)
    swap_parts = swap_host_ms(session, final)
    prof = profile_tune(updater, 10) if device == "cuda" else None
    steps = len(stream.steps)
    n_ref = tele["refreshes"]
    out = {
        "stream": sizes, "caps": caps, "rungs": rungs,
        "bootstrap": {**{k: boot[k] for k in ("k_users", "k_items",
                                               "gamma", "iters")},
                      "build_s": t_build, "train_s": t_train,
                      "train_steps": bootstrap_steps},
        "steps": steps, "replay_s": t_replay,
        "cold_assign_ms": [t["cold_assign_ms"] for t in timing],
        "refresh_ms": [t["refresh_ms"] for t in timing if "refresh_ms" in t],
        "refresh_sweeps": [r["sweeps"] for r in rec if "sweeps" in r],
        "tune_ms_per_step": (report["tune_total_ms"]
                             / max(cfg.tune_steps * n_ref, 1)),
        "swap_p50_ms": swap_ms["p50"], "swap_max_ms": swap_ms["max"],
        "delta_kb_mean": report["delta_bytes_mean"] / 1024,
        "request_p50_ms": st["p50_ms"], "requests": st["requests"],
        "b64_p50_ms": lat, "swap_parts_ms": swap_parts,
        "tune_profile": prof,
        "swap_allocations": session.state_allocations - alloc0 + swap_alloc,
        "capacity_bumps": tele["capacity_bumps"],
        "churn": [[t["churn_users"], t["churn_items"]] for t in timing
                  if "churn_users" in t],
        "launches": launches, "weighted_launches": weighted,
        "near_tie_ids": n_diff, "plain_checks": plain}
    return out


@contextlib.contextmanager
def plain_versions():
    """Route the LightGCN path's kernel wrappers to their plain PyTorch
    versions (``repro_torch.kernels.ref``) on device tensors, for a
    comparison on the same inputs: the propagation's weighted CSR
    gather-sum, the codebook backward's CSR gather-sum and
    ``codebook_lookup``. It fails if any kernel launched inside."""
    import importlib

    from repro_torch.kernels import ops, ref
    from repro_torch.models import lightgcn as L

    # the package exports a function of the module's name
    eb = importlib.import_module("repro_torch.kernels.embedding_bag")
    before = launch_counts()
    saved = (L.csr_gather_sum, eb.csr_gather_sum, ops.codebook_lookup)
    L.csr_gather_sum = eb.csr_gather_sum = ref.csr_gather_sum
    ops.codebook_lookup = ref.codebook_lookup
    try:
        yield
    finally:
        L.csr_gather_sum, eb.csr_gather_sum, ops.codebook_lookup = saved
    require(launch_counts() == before,
            "a kernel launched inside the plain versions")


def check_stream_kernels(updater, session, ids, device: str) -> dict:
    """The stream path's kernels against their plain versions at the
    stream's own shapes, on the same device tensors, after the replay:

      * one tuner batch on the tuner's padded device state: the BPR loss
        and both codebook gradients (codebook_lookup over the padded
        sketches; the weighted CSR gather-sum forward and backward over
        the padded edges, whose trailing segments are empty and whose
        pad edges lie past ``ptr[S]``; the codebook backward, with every
        pad sketch row folded into codebook row 0), bitwise; the pad
        codebook rows' gradients are exactly 0;
      * the padded session's ``all_embeddings``, bitwise;
      * ``fused_topk`` over the padded items with the ``-inf`` item mask
        against the plain top-k: ids agree up to near-ties
        (``topk_agree``), the ``-inf`` pattern is equal, no pad item is
        returned.

    The tuner's device statics must also equal the host padding of the
    final graph bitwise (the in-place install on the card)."""
    import numpy as np
    import torch

    from repro_torch.data.sampler import BPRSampler
    from repro_torch.embedding import dequantize_params
    from repro_torch.kernels import fused_topk, ref
    from repro_torch.models import lightgcn as L
    from repro_torch.serve.session import pad_to_capacity

    updater.tune(0)       # install the final graph into the tuner's state
    tuner, graph, sketch = updater._tuner, updater.sgraph.graph, \
        updater.sketch
    mcfg = L.from_sketch(graph, sketch, dim=int(updater.model["dim"]),
                         n_layers=int(updater.model["n_layers"]),
                         l2=float(updater.model["l2"]),
                         lookup_backend=updater.model.get("lookup_backend"))
    host = {k: v.numpy()
            for k, v in L.make_statics(graph, sketch, "cpu").items()}
    _, statics_p, mcfg_pad, caps, bumped = pad_to_capacity(
        updater.params, host, mcfg, tuner._caps)
    require(not bumped and set(statics_p) == set(tuner._statics)
            and all(torch.equal(tuner._statics[k].cpu(),
                                torch.from_numpy(v))
                    for k, v in statics_p.items()),
            "the tuner's device statics are not the host padding of the "
            "final graph")
    params, statics = tuner._params, tuner._statics
    names = sorted(params)
    u, p, n = BPRSampler(graph, tuner.batch_size, seed=0).next_batch()
    batch = {"user": torch.as_tensor(u, device=device),
             "pos": torch.as_tensor(p, device=device),
             "neg": torch.as_tensor(n, device=device)}

    def loss_and_grads():
        loss = L.bpr_loss_fn(params, statics, batch, mcfg_pad)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        return [loss.detach()] + list(grads)

    def serve_embeddings():
        with torch.no_grad():
            return list(L.all_embeddings(dequantize_params(session.params),
                                         session.statics, session.mcfg))

    before, w0 = launch_counts(), weighted_launches()
    got_tune, got_emb = loss_and_grads(), serve_embeddings()
    require(launch_counts()["codebook_lookup"] > before["codebook_lookup"]
            and weighted_launches() > w0,
            "a kernel never ran in the stream checks")
    with plain_versions():
        want_tune, want_emb = loss_and_grads(), serve_embeddings()
    sync(device)
    out = {}
    for what, got, want in (
            ("tune", got_tune, want_tune),
            ("all_embeddings", got_emb, want_emb)):
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"stream {what}: kernels differ from the plain versions "
                f"(max abs err {err})")
        out[what] = err
    k_real = {"user_table": sketch.k_users, "item_table": sketch.k_items}
    for name, grad in zip(names, got_tune[1:]):
        require(not grad[k_real[name]:].any(),
                f"{name}: a pad codebook row has a nonzero gradient")
    # fused_topk over the padded items, -inf on the pads
    mask = session.statics["item_mask"]
    u_all, v_all = got_emb
    uq = u_all[torch.as_tensor(ids, device=device)].contiguous()
    got_v, got_i = fused_topk(uq, v_all, session.k, mask=mask)
    want_v, want_i = ref.fused_topk(uq, v_all, session.k, mask=mask)
    n_diff = topk_agree(got_v.cpu(), got_i.cpu(), want_v.cpu(),
                        want_i.cpu(), pair_scorer(uq, v_all, mask=mask))
    require(torch.equal(torch.isfinite(got_v), torch.isfinite(want_v)),
            "fused_topk's -inf pattern over the padded items differs")
    n_real = int(graph.n_items)
    require(int(got_i.max()) < n_real, "fused_topk returned a pad item")
    fin = torch.isfinite(want_v)
    out["fused_topk"] = float((got_v[fin] - want_v[fin]).abs().max())
    out["fused_topk_near_tie_ids"] = n_diff
    log(f"stream kernels vs plain versions at the stream's shapes: one "
        f"tuner batch of {len(u)} (loss, grads) and the padded session's "
        f"all_embeddings bitwise ({mcfg_pad.n_users} x {mcfg_pad.n_items} "
        f"padded, {int(statics['edge_u'].shape[0])} padded edges, "
        f"{int(graph.n_edges)} real); fused_topk over {v_all.shape[0]} "
        f"items ({v_all.shape[0] - n_real} -inf pads) agrees ({n_diff} ids "
        f"differ at near-ties, max abs err {out['fused_topk']})")
    return out


def serve_padded_vs_unpadded(padded, fresh, ids, device: str,
                             n: int = 9) -> dict:
    """p50 ms of ``n`` requests of the same ids on the padded session and
    on a fresh unpadded one over the same artifact, in turns (host clock
    around each call, which ends in a synchronize)."""
    import statistics
    out = {"padded": [], "unpadded": []}
    for _ in range(n):
        for name, s in (("padded", padded), ("unpadded", fresh)):
            t0 = time.perf_counter()
            s(ids)
            out[name].append((time.perf_counter() - t0) * 1e3)
    res = {k: statistics.median(v) for k, v in out.items()}
    log(f"B={len(ids)} request p50: padded {res['padded']:.4f} ms, "
        f"unpadded {res['unpadded']:.4f} ms ({n} each, in turns)")
    return res


def swap_host_ms(session, artifact) -> dict:
    """Where a swap's time goes: its host-side parts timed alone (the
    artifact's statics rebuilt on the host, then padded to the session's
    rungs), beside one more whole swap of the same artifact."""
    from repro_torch.serve.session import _host_state, _pad_state
    t0 = time.perf_counter()
    params, statics = _host_state(artifact)
    t1 = time.perf_counter()
    mcfg = dataclasses.replace(artifact.mcfg(),
                               lookup_backend=session.mcfg.lookup_backend)
    _pad_state(params, statics, mcfg, session.stats()["capacity"])
    t2 = time.perf_counter()
    whole = session.swap(artifact)
    out = {"host_state": (t1 - t0) * 1e3, "pad_state": (t2 - t1) * 1e3,
           "whole_swap": whole["ms"]}
    require(whole["state_allocations"] == 0, "a repeated swap allocated")
    log(f"swap parts (ms): {out}")
    return out


def profile_tune(updater, n: int) -> dict:
    """One ``updater.tune(n)`` under ``torch.profiler``: device time per
    tuning step by kernel, wall time per step (set-up included), idle
    share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        updater.tune(n)                     # ends in a copy to the host
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = device_times(prof, n)
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    log(f"profile (stream tune, {n} steps): device busy {busy:.3f} ms of "
        f"{wall_ms / n:.3f} ms a step")
    for name, ms in top:
        log(f"  {ms:8.4f} ms  {100 * ms / busy:5.1f}%  {name}")
    return {"steps": n, "device_ms_per_step": busy,
            "wall_ms_per_step": wall_ms / n,
            "idle_share": 1.0 - busy / (wall_ms / n),
            "top_kernels_ms": dict(top)}


# ---------------------------------------------------------------------------
# phase 2c: the serving front end under open-loop load
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def recorded_session_calls(calls: list):
    """Every ``RecsysSession.__call__`` inside appends ``(artifact_id,
    padded ids, (values, items))``: the device batches as the sessions
    saw them, bucket padding included."""
    import numpy as np

    from repro_torch.serve import RecsysSession
    inner = RecsysSession.__call__

    def call(self, user_ids):
        out = inner(self, user_ids)
        calls.append((self.artifact_id, np.array(user_ids), out))
        return out

    RecsysSession.__call__ = call
    try:
        yield calls
    finally:
        RecsysSession.__call__ = inner


class VersionCheck:
    """Fresh unpadded fused sessions over the served versions, and the
    near-tie rule of :func:`topk_agree` against each."""

    def __init__(self, artifacts: dict, device: str):
        from repro_torch.launch.load_bench import BUCKETS
        from repro_torch.serve import BatchDispatcher
        self.artifacts = artifacts
        self.device = device
        self.sessions = {aid: art.session(k=20, scorer="fused",
                                          device=device)
                         for aid, art in artifacts.items()}
        self.dispatchers = {aid: BatchDispatcher(s, BUCKETS)
                            for aid, s in self.sessions.items()}
        self._emb = {}
        self.near_tie_ids = 0

    def _score(self, aid, ids):
        import numpy as np
        import torch

        from repro_torch.embedding import dequantize_params
        from repro_torch.models import lightgcn as L
        if aid not in self._emb:
            art = self.artifacts[aid]
            params = {k: torch.as_tensor(v, device=self.device)
                      for k, v in art.serving_params().items()}
            statics = art.statics(torch.device(self.device))
            self._emb[aid] = (*L.all_embeddings(
                dequantize_params(params), statics, art.mcfg()), statics)
        u_all, v_all, statics = self._emb[aid]
        rows = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
        return pair_scorer(u_all[rows], v_all,
                           mask=statics.get("item_mask"))

    def agrees(self, aid, ids, vals, items, want=None) -> bool:
        """``(vals, items)`` served for ``ids`` equal the fresh session of
        version ``aid`` (``want``, its output on the same padded batch,
        else a fresh dispatch of ``ids``), bitwise or within near-ties."""
        import numpy as np
        if want is None:
            want = self.dispatchers[aid](ids)
        want = [np.asarray(x.cpu() if hasattr(x, "cpu") else x)
                for x in want]
        vals, items = (np.asarray(x.cpu() if hasattr(x, "cpu") else x)
                       for x in (vals, items))
        try:
            n = topk_agree(vals, items, want[0], want[1],
                           self._score(aid, ids))
        except SmokeFailure:
            return False
        self.near_tie_ids += n
        return True


def frontdoor_run(base, v2, shared, qps: float, device: str, versions,
                  no_shed: bool) -> dict:
    """One open-loop run of the load bench's scenario on fresh tenants:
    launch counts zeroed just before and read just after; then every
    device batch and every response checked against fresh sessions."""
    from repro_torch.launch import load_bench as LB
    fd = LB.frontdoor(base, flush_ms=2.0, queue_size=256,
                      cache_entries=1024, device=device)
    calls, submitted = [], {}
    sync(device)
    zero_counts()
    with recorded_session_calls(calls):
        rec = LB.run(fd, v2, qps=qps, duration=FRONTDOOR_DURATION_S,
                     seed=0, log=submitted)
    sync(device)
    counts = launch_counts()
    launches = {n: counts[n] for n in ("codebook_lookup", "fused_topk",
                                       "embedding_bag")}
    launches["weighted"] = weighted_launches()
    accounted = rec["responses"] + rec["shed"] + rec["timeouts"] \
        + rec["failed"]
    require(accounted == rec["offered"] and rec["failed"] == 0,
            f"{qps} qps: arrivals unaccounted or failed: {rec}")
    require(rec["swap_mode"] == "swapped",
            f"{qps} qps: web swapped by mode {rec['swap_mode']}")
    require(rec["state_allocations_under_load"] == 0,
            f"{qps} qps: {rec['state_allocations_under_load']} device state "
            f"allocations under load")
    for name in ("codebook_lookup", "fused_topk", "embedding_bag",
                 "weighted"):
        require(launches[name] > 0,
                f"{name} never ran on the frontdoor path")

    # every device batch, at its own padded bucket
    ids_v1, ids_v2 = base.content_id(), v2.content_id()
    require({a for a, _, _ in calls} <= {ids_v1, ids_v2,
                                         shared.content_id()},
            "a session served an unknown version")
    for aid, ids, out in calls:
        require(versions.agrees(aid, ids, *out,
                                want=versions.sessions[aid](ids)),
                f"{qps} qps: a device batch of {ids.size} differs from a "
                f"fresh session of its version")
    # every response: its version, wholly, and the swap's order
    swap = submitted["swap"]
    served = {"v1": 0, "v2": 0, "either": 0, "int8": 0}
    for i, (tenant, ids, ticket) in enumerate(submitted["requests"]):
        if ticket.error() is not None:
            continue                              # a timeout, counted
        vals, items = ticket.result(timeout=60)
        if tenant != "web":
            require(versions.agrees(shared.content_id(), ids, vals, items),
                    f"{tenant} response differs from the int8 base")
            served["int8"] += 1
            continue
        is_v1 = versions.agrees(ids_v1, ids, vals, items)
        is_v2 = versions.agrees(ids_v2, ids, vals, items)
        require(is_v1 or is_v2,
                "a web response is neither wholly v1 nor wholly v2")
        if i >= swap["submitted_before"]:
            require(is_v2, "a request submitted after the swap returned "
                    "was not served by v2")
        if ticket.t_done < swap["t_start"]:
            require(is_v1, "a response resolved before the swap began "
                    "was not served by v1")
        served["either" if is_v1 and is_v2 else
               "v1" if is_v1 else "v2"] += 1
    if no_shed:
        require(rec["shed"] == 0, f"{qps} qps shed {rec['shed']} requests")
    rec["launches"] = launches
    rec["responses_checked"] = served
    rec["device_batches_checked"] = len(calls)
    log(f"frontdoor {qps:g} qps: offered {rec['offered_qps']} -> "
            f"sustained {rec['sustained_qps']}; e2e p50/p99 "
            f"{rec['e2e_p50_ms']}/{rec['e2e_p99_ms']} ms, queue p50/p99 "
            f"{rec['queue_delay_p50_ms']}/{rec['queue_delay_p99_ms']} ms; "
            f"fill {rec['batch_fill_mean']} buckets {rec['bucket_counts']}; "
            f"shed {rec['shed']} timeouts {rec['timeouts']} cache hits "
            f"{rec['cache_hits']}; swap {rec['swap_mode']} pause "
            f"{rec['swap_pause_ms']} ms (drain {rec['swap_drain_ms']}); "
            f"allocations {rec['state_allocations_under_load']}, allocator "
            f"segments +{rec['allocator_segments_under_load']}; launches "
            f"{launches}")
    log(f"frontdoor {qps:g} qps: {len(calls)} device batches and "
        f"{sum(served.values())} responses ({served}) equal fresh "
        f"sessions of their versions")
    return rec


def frontdoor_path(run: dict, device: str = "cuda",
                   extra_steps: int = 40) -> dict:
    """The serving front end (``repro_torch.frontdoor``) over the main
    path's trained export: v2 is the main path's trainer fine-tuned
    ``extra_steps`` more steps and shipped as a verified delta; then one
    open-loop run per rate in ``FRONTDOOR_RATES`` (the load bench's
    three tenants, ``web`` swapping to v2 halfway)."""
    from repro_torch.launch import load_bench as LB
    base = run["loaded"]
    t0 = time.perf_counter()
    v2 = LB.ship_v2(run["training"]["trainer"], run["training"]["artifact"],
                    extra_steps)
    require(v2.content_id() != base.content_id(), "v2 equals the base")
    shared = base.quantize()
    versions = VersionCheck({a.content_id(): a for a in (base, v2, shared)},
                            device)
    log(f"frontdoor: v2 {v2.content_id()} = base + delta after "
        f"{extra_steps} more steps ({time.perf_counter() - t0:.1f} s)")
    out = {"rates": {}}
    for i, qps in enumerate(FRONTDOOR_RATES):
        out["rates"][f"{qps:g}"] = frontdoor_run(
            base, v2, shared, qps, device, versions, no_shed=i == 0)
    out["near_tie_ids"] = versions.near_tie_ids
    out["bitwise"] = versions.near_tie_ids == 0
    log(f"frontdoor: every response checked "
        f"{'bitwise' if out['bitwise'] else 'within near-ties'} "
        f"({versions.near_tie_ids} ids at near-ties)")
    out["launches"] = {
        n: sum(r["launches"][n] for r in out["rates"].values())
        for n in ("codebook_lookup", "fused_topk", "embedding_bag",
                  "weighted")}
    return out


# ---------------------------------------------------------------------------
# phase 2d: the cluster build at scale (the 100k and 1M rungs)
# ---------------------------------------------------------------------------
def segsum_row(values, seg, n: int) -> dict:
    """The ordered W(k) sum on the card: the solver's route (a stable
    sort and one CSR gather-sum launch) bitwise against its plain version
    (``ref.segment_sum``, one ``index_add_`` per rank within a segment),
    both timed beside ``index_add_`` (atomic, so not ordered)."""
    import torch

    from repro_torch.core import solver_torch
    from repro_torch.kernels import cost as kcost, ref
    got = solver_torch.segment_sum_ordered(values, seg, n)
    want = ref.segment_sum(values, seg, n)
    require(torch.equal(got, want),
            "the ordered W(k) sum is not bitwise its plain version")
    m = int(seg.shape[0])
    steps = int(torch.bincount(seg, minlength=n).max()) if m else 0
    # values and labels read, sums written; one add per value
    bms, by = kcost.bound(kcost.Cost(4 * m + 8 * m + 4 * n, m))
    return {"shape": f"M={m} segments={n}", "plain_steps": steps,
            "ms": time_ms(lambda: solver_torch.segment_sum_ordered(
                values, seg, n)),
            "plain_ms": time_ms(lambda: ref.segment_sum(values, seg, n),
                                iters=5, warmup=1),
            "library_ms": time_ms(lambda: torch.zeros(
                n, device=values.device).index_add_(0, seg, values)),
            "bound_ms": bms, "bound_by": by,
            "max_abs_err": float((got - want).abs().max()) if n else 0.0}


def scale_path(device: str = "cuda", rungs=("100k", "1m"),
               reference=None, blocks=None) -> dict:
    """The scale ladder's rungs through ``repro_torch.launch.cluster_scale``
    (``planted_coclusters``, average degree 8, gamma 0.5, 8 sweeps). Each
    rung: the streamed solve at its two block sizes on a graph no
    in-memory solve has touched, then the in-memory "torch" solve (its
    peak from a reset, with the device edge lists dropped before and
    after); at 100k also "torch_hostloop" and the minhash cold-assign
    experiment; the shard balance at 8 shards (host numpy, the
    reference's ``shard_imbalance_*``). Labels and sweeps must be equal
    across the solves and the reference's (``SCALE_REFERENCE``), and at
    the smaller block size the streamed peak device bytes must lie below
    the in-memory solve's.
    Launch counts are zeroed just before the first solve and read just
    after the last; the CSR gather-sum (the ordered W(k) sums) must have
    run. Then the ordered W(k) sum on each rung's final labels is held
    bitwise against its plain version and timed."""
    import numpy as np
    import torch

    from repro_torch.core import make_weights
    from repro_torch.core.metrics import bipartite_modularity
    from repro_torch.launch import cluster_scale as cs

    ref = reference or SCALE_REFERENCE
    blocks = blocks or SCALE_BLOCKS
    graphs = {}
    for rung in rungs:
        g, build_s = cs.build_rung(rung)
        graphs[rung] = (g, build_s, make_weights(g, "hws"))
        log(f"scale {rung}: {g.n_users} x {g.n_items}, {g.n_edges} edges "
            f"(built in {build_s:.2f} s on the host)")
    zero_counts()
    out, finals = {}, {}
    for rung in rungs:
        g, build_s, (wu, wv) = graphs[rung]
        rec = {"n_nodes": g.n_nodes, "n_edges": g.n_edges,
               "build_s": build_s, "streamed": {}}
        # host numpy: the reference's shard balance at 8 shards
        rec["shard_imbalance_uniform"], rec["shard_imbalance_aligned"] = \
            cs.shard_balance(g)
        log(f"scale {rung}: shard imbalance at 8 shards (max / mean "
            f"edges): uniform node ranges {rec['shard_imbalance_uniform']}, "
            f"node-aligned bounds {rec['shard_imbalance_aligned']}")
        labels = {}
        for be in blocks[rung]:
            lab, it, st, sec = cs.solve_streamed(g, wu, wv, be, device)
            labels[f"streamed/{be}"] = (lab, it)
            rec["streamed"][str(be)] = {**st, "solve_s": sec}
            log(f"scale {rung}: streamed block_edges={be}: {it} sweeps in "
                f"{sec:.3f} s (fastest sweep {st['sweep_ms']:.3f} ms, "
                f"{st['blocks_per_s']:.1f} blocks/s, "
                f"{st['n_blocks_user']}+{st['n_blocks_item']} blocks padded "
                f"to {st['block_pad_user']}/{st['block_pad_item']}), peak "
                f"{st['peak_device_bytes']} bytes "
                f"[{st['peak_bytes_source']}]")
        base = int(torch.cuda.memory_allocated()) if device == "cuda" else 0
        lab, it, sec, peak = cs.solve_inmem(g, wu, wv, device)
        labels["torch"] = (lab, it)
        rec["inmem"] = {"sweeps": it, "solve_s": sec,
                        "peak_device_bytes": peak,
                        "allocated_before_bytes": base}
        log(f"scale {rung}: in-memory torch: {it} sweeps in {sec:.3f} s, "
            f"peak {peak} bytes ({base} allocated before)")
        if rung == "100k":
            lab, it, sec, _ = cs.solve_inmem(g, wu, wv, device,
                                             solver="torch_hostloop")
            labels["torch_hostloop"] = (lab, it)
            rec["hostloop"] = {"sweeps": it, "solve_s": sec}
            log(f"scale {rung}: torch_hostloop: {it} sweeps in {sec:.3f} s")
        lab0, it0 = labels["torch"]
        for name, (lab, it) in labels.items():
            require(np.array_equal(lab, lab0) and it == it0,
                    f"scale {rung}: {name} differs from the in-memory solve")
        got = {"n_edges": g.n_edges, "labels": digest(lab0.astype(np.int32)),
               "iters": it0, "modularity": bipartite_modularity(g, lab0)}
        require(got == ref[rung], f"scale {rung}: {got} is not the "
                f"reference's {ref[rung]}")
        small = rec["streamed"][str(min(blocks[rung]))]["peak_device_bytes"]
        if device == "cuda":
            require(small < rec["inmem"]["peak_device_bytes"],
                    f"scale {rung}: streamed peak {small} bytes is not below "
                    f"the in-memory solve's {rec['inmem']['peak_device_bytes']}")
        rec["reference"] = got
        log(f"scale {rung}: {len(labels)} solves equal, and equal to the "
            f"reference (labels {got['labels']}, {it0} sweeps, modularity "
            f"{got['modularity']})")
        if rung == "100k":
            t0 = time.perf_counter()
            rec["cold"] = c = cs.cold_experiment(g, lab0, device)
            log(f"scale {rung}: cold-assign {c['n_cold_users']} users in "
                f"{time.perf_counter() - t0:.2f} s: exact {c['exact_ms']:.2f}"
                f" ms, minhash {c['minhash_total_ms']:.2f} ms (index "
                f"{c['cand_ms']:.2f} ms), recall {c['minhash_recall']}, "
                f"{c['mean_candidates']:.1f} candidates of {c['n_labels']} "
                f"labels")
        finals[rung] = lab0
        out[rung] = rec
    sync(device)
    counts = launch_counts()
    launches = {"embedding_bag": counts["embedding_bag"]}
    log(f"kernel launches on the scale path: {launches}")
    require(launches["embedding_bag"] > 0,
            "embedding_bag never ran on the scale path")
    if device == "cuda":
        for rung in rungs:
            g, _, (wu, wv) = graphs[rung]
            lab = torch.as_tensor(finals[rung], dtype=torch.int64,
                                  device=device)
            rows = {}
            for side, w, seg in (
                    ("items", wv, lab[g.n_users:]),
                    ("users", wu, lab[:g.n_users])):
                rows[side] = segsum_row(
                    torch.as_tensor(np.asarray(w, np.float32),
                                    device=device), seg, g.n_nodes)
            steps = rows["items"]["plain_steps"] + rows["users"]["plain_steps"]
            out[rung]["segment_sum"] = {
                **rows, "plain_steps_per_sweep": steps,
                "ms_per_sweep": rows["items"]["ms"] + rows["users"]["ms"],
                "plain_ms_per_sweep": (rows["items"]["plain_ms"]
                                       + rows["users"]["plain_ms"])}
            log(f"scale {rung}: ordered W(k) sums of the final labels "
                f"bitwise their plain version: "
                f"{out[rung]['segment_sum']['ms_per_sweep']:.4f} ms a sweep "
                f"(plain: {steps} steps, "
                f"{out[rung]['segment_sum']['plain_ms_per_sweep']:.4f} ms)")
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# phase 2e: the paper's comparison (ETC baselines and parameter accounting)
# ---------------------------------------------------------------------------
def baselines_path(run: dict, workdir: str, device: str = "cuda",
                   steps: int = BASELINE_TRAIN_STEPS,
                   check_dataset: str = "gowalla_s") -> dict:
    """The baselines of ``BASELINE_METHODS`` built on the main path's
    graph at budget 0.25 x nodes (the train launcher's), ``lp``/``lpab``
    through the GPU solver; their K and parameters against full. At
    ``check_dataset`` the GPU ``lp``/``lpab`` sketches must equal the
    CPU port's. Then ``double`` (2-hot on both sides) as the train
    launcher runs it: ``steps`` fused steps at batch 2,048,
    Recall/NDCG@20 on 4,096 test users beside the main path's BACO,
    export, int8 quantization (``n_params``/``serving_nbytes``; int8
    must be smaller), 13 fused requests against a fresh session. Launch
    counts are zeroed before training and before serving and read after
    each; codebook_lookup (items H = 2), the CSR gather-sum and
    fused_topk must have run. The items' H = 2 lookup is then held
    against its plain version and timed."""
    import numpy as np
    import torch

    from repro_torch.core import build_sketch
    from repro_torch.data import paperlike_dataset
    from repro_torch.kernels import codebook_lookup, ref
    from repro_torch.kernels import cost as kcost
    from repro_torch.serve import CompressedArtifact, RecsysSession
    from repro_torch.training import TrainConfig, Trainer

    train, test = run["train"], run["test"]
    budget = int(0.25 * train.n_nodes)
    full = (train.n_users + train.n_items) * 64
    sketches, builds = {}, {}
    for name in BASELINE_METHODS:
        t0 = time.perf_counter()
        sk = build_sketch(name, train, budget, device=device)
        sync(device)
        sec = time.perf_counter() - t0
        sketches[name] = sk
        builds[name] = {"k_users": sk.k_users, "k_items": sk.k_items,
                        "hot": [int(sk.user_idx.shape[1]),
                                int(sk.item_idx.shape[1])],
                        "n_params": sk.n_params(64), "full_params": full,
                        "build_s": sec}
        log(f"baseline {name}: K_u={sk.k_users} K_v={sk.k_items} "
            f"(H {builds[name]['hot']}), {sk.n_params(64)} params = "
            f"{sk.n_params(64) / full:.4f} of full, built in {sec:.2f} s")
    bk = run["sketch"]
    builds["baco"] = {"k_users": bk.k_users, "k_items": bk.k_items,
                      "n_params": bk.n_params(64), "full_params": full,
                      "build_s": run["cluster_s"]}
    _, _, _, small, _ = paperlike_dataset(check_dataset, seed=0)
    b_small = int(0.25 * small.n_nodes)
    for name in ("lp", "lpab"):
        a = build_sketch(name, small, b_small, device=device)
        b = build_sketch(name, small, b_small, device="cpu")
        require(np.array_equal(a.user_idx, b.user_idx)
                and np.array_equal(a.item_idx, b.item_idx)
                and a.meta["iters"] == b.meta["iters"],
                f"{check_dataset}: the GPU {name} sketch is not the CPU's")
    log(f"{check_dataset}: GPU lp and lpab sketches equal the CPU port's")
    cce_res = cce_path(device, check_dataset=check_dataset)

    sk = sketches["double"]
    cfg = TrainConfig(steps=steps, batch_size=2048, lr=5e-3, seed=0,
                      backend="fused", chunk_size=16)
    tr = Trainer(train, sk, cfg, device=device)
    zero_counts()
    sync(device)
    t0 = time.perf_counter()
    losses = tr.run(log_every=0)
    sync(device)
    t_train = time.perf_counter() - t0
    counts = launch_counts()
    train_launches = {n: counts[n] for n in ("codebook_lookup",
                                             "embedding_bag")}
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"double: the loss did not fall: {losses[0]} -> {losses[-1]}")
    metrics = tr.evaluate(test, max_users=4096, topk_backend="block")
    baco = run["training"]["trained"]["block"]
    log(f"double: {steps} fused steps in {t_train:.2f} s, loss "
        f"{losses[0]:.5f} -> {losses[-1]:.5f}; Recall/NDCG@20 {metrics} "
        f"(BACO after {run['training']['steps']} steps: {baco})")
    art = tr.export(os.path.join(workdir, "double"))
    loaded = CompressedArtifact.load(os.path.join(workdir, "double"))
    require(loaded.content_id() == art.content_id(),
            "double: content_id changed across save/load")
    q = loaded.quantize()
    acct = {"n_params_fp32": loaded.n_params(),
            "serving_nbytes_fp32": loaded.serving_nbytes(),
            "n_params_int8": q.n_params(),
            "serving_nbytes_int8": q.serving_nbytes(),
            "compressed": loaded.compressed}
    require(loaded.n_params() == sk.n_params(64),
            "double: the artifact's n_params is not the sketch's")
    require(acct["serving_nbytes_int8"] < acct["serving_nbytes_fp32"],
            f"double: int8 is not smaller than fp32: {acct}")
    log(f"double export: {acct}")

    rng = np.random.default_rng(1)
    sizes = [1, 8, 64, 512] + [int(x) for x in rng.integers(1, 513, 9)]
    batches = [rng.integers(0, train.n_users, x) for x in sizes]
    session = RecsysSession.from_artifact(loaded, k=20, scorer="fused",
                                          device=device)
    zero_counts()
    t0 = time.perf_counter()
    outs = [session(b) for b in batches]
    sync(device)
    t_serve = time.perf_counter() - t0
    counts = launch_counts()
    serve_launches = {n: counts[n] for n in ("codebook_lookup", "fused_topk",
                                             "embedding_bag")}
    fresh = RecsysSession.from_artifact(loaded, k=20, scorer="fused",
                                        device=device)
    for b, (v, i) in zip(batches, outs):
        fv, fi = fresh(b)
        require(v.shape == (b.size, 20) and torch.isfinite(v).all(),
                "double: bad top-k values")
        require(torch.equal(v, fv) and torch.equal(i, fi),
                "double: a served request differs from a fresh session's")
    log(f"double: {len(batches)} fused requests in {t_serve:.3f} s, "
        f"bitwise a fresh session's; launches training {train_launches}, "
        f"serving {serve_launches}")
    for phase, launched in (("training", train_launches),
                            ("serving", serve_launches)):
        for name, n in launched.items():
            require(n > 0, f"{name} never ran on the baselines {phase} path")
    row = None
    if device == "cuda":
        z = torch.as_tensor(loaded.params["item_table"], device=device)
        ix = torch.as_tensor(sk.item_idx, dtype=torch.int32, device=device)
        got = codebook_lookup(z, ix, binary=True)
        want = ref.codebook_lookup(z, ix, binary=True)
        require(torch.equal(got, want), "codebook_lookup (items H = 2) is "
                "not bitwise the plain version")
        b, h = ix.shape
        bms, by = kcost.bound(kcost.codebook_lookup(z, ix, rows=z.shape[0]))
        ixl = ix.long()
        row = {"shape": f"B={b} H={h} K={z.shape[0]} d={z.shape[1]}",
               "ms": time_ms(lambda: codebook_lookup(z, ix, binary=True)),
               "plain_ms": time_ms(lambda: ref.codebook_lookup(
                   z, ix, binary=True)),
               "library_ms": time_ms(lambda: z[ixl].sum(1)),
               "bound_ms": bms, "bound_by": by,
               "max_abs_err": float((got - want).abs().max())}
        log(f"codebook_lookup items H=2 {row['shape']}: bitwise equal; {row}")
    return {"budget": budget, "builds": builds, "cce": cce_res,
            "double": {"steps": steps, "train_s": t_train,
                       "loss_first": losses[0], "loss_last": losses[-1],
                       "metrics": metrics, "baco_metrics": baco, **acct,
                       "serve_s": t_serve, "requests": len(batches)},
            "launches": {
                "training": train_launches, "serving": serve_launches,
                "codebook_lookup": (train_launches["codebook_lookup"]
                                    + serve_launches["codebook_lookup"]),
                "embedding_bag": (train_launches["embedding_bag"]
                                  + serve_launches["embedding_bag"]),
                "fused_topk": serve_launches["fused_topk"]},
            "codebook_items_h2": row}


def cce_path(device: str = "cuda", check_dataset: str = "gowalla_s") -> dict:
    """CCE through ``train_cce`` on ``device`` at ``CCE_DATASET`` (budget
    0.25 x nodes, ``CCE_STEPS``): training and eval on the card, the
    k-means on the host (its seconds timed); Recall/NDCG@20 and params
    beside BACO's on the same graph in the same protocol
    (``ClusterEngine`` at ratio 0.25, 400 steps). Counts zeroed just
    before ``train_cce`` and read just after: codebook_lookup and the CSR
    gather-sum must run. At ``check_dataset`` the card's CCE must match
    the CPU port's (``CCE_CHECK``): the reclustered sketch equal (the
    CPU tests hold the CPU port's bitwise against the reference's), and
    Recall@20 within ``CCE_RECALL_TOL``."""
    import numpy as np

    from repro_torch.core import ClusterEngine
    from repro_torch.data import paperlike_dataset
    from repro_torch.training import TrainConfig, Trainer, cce

    t0 = time.perf_counter()
    _, _, _, train, test = paperlike_dataset(CCE_DATASET, seed=0)
    budget = int(0.25 * train.n_nodes)
    kmeans_s = []
    orig = cce._kmeans

    def timed(*a, **kw):
        t = time.perf_counter()
        out = orig(*a, **kw)
        kmeans_s.append(time.perf_counter() - t)
        return out
    cce._kmeans = timed
    try:
        zero_counts()
        t = time.perf_counter()
        m, sk, tr = cce.train_cce(train, test, budget=budget, device=device,
                                  **CCE_STEPS)
        sync(device)
        cce_s = time.perf_counter() - t
        launches = {k: v for k, v in launch_counts().items() if v}
    finally:
        cce._kmeans = orig
    for name in ("codebook_lookup", "embedding_bag"):
        require(launches.get(name, 0) > 0, f"{name} never ran in CCE")
    require(m["params"] == sk.n_params(64) and 0 < m["recall"] <= 1,
            f"CCE: {m}, sketch params {sk.n_params(64)}")
    t = time.perf_counter()
    bsk = ClusterEngine(device=device).build(train, d=64, ratio=0.25)
    btr = Trainer(train, bsk, TrainConfig(dim=64, steps=CCE_STEPS["steps"],
                                          batch_size=2048, lr=5e-3, seed=0),
                  device=device)
    btr.run(log_every=0)
    baco = btr.evaluate(test)
    baco["params"] = btr.n_params()
    baco_s = time.perf_counter() - t
    res = {"dataset": CCE_DATASET, "users": train.n_users,
           "items": train.n_items, "budget": budget, **CCE_STEPS,
           "cce": {**m, "k": [sk.k_users, sk.k_items], "seconds": cce_s,
                   "kmeans_s": kmeans_s},
           "baco": {**baco, "k": [bsk.k_users, bsk.k_items],
                    "seconds": baco_s},
           "launches": launches}
    del tr, btr
    _, _, _, small, stest = paperlike_dataset(check_dataset, seed=0)
    b_small = int(0.25 * small.n_nodes)
    t = time.perf_counter()
    got = cce.train_cce(small, stest, budget=b_small, device=device,
                        **CCE_CHECK)
    want = cce.train_cce(small, stest, budget=b_small, device="cpu",
                         **CCE_CHECK)
    k_got = [got[1].k_users, got[1].k_items]
    k_want = [want[1].k_users, want[1].k_items]
    diff = abs(got[0]["recall"] - want[0]["recall"])
    equal = bool(k_got == k_want
                 and np.array_equal(got[1].user_idx, want[1].user_idx)
                 and np.array_equal(got[1].item_idx, want[1].item_idx))
    res["check"] = {"dataset": check_dataset, **CCE_CHECK, "k": k_got,
                    "k_cpu": k_want, "recall": got[0]["recall"],
                    "recall_cpu": want[0]["recall"], "recall_diff": diff,
                    "tol": CCE_RECALL_TOL, "sketch_equal": equal,
                    "seconds": time.perf_counter() - t}
    require(equal, f"{check_dataset}: the card's reclustered CCE sketch "
            f"(K {k_got}) is not the CPU's (K {k_want})")
    require(diff <= CCE_RECALL_TOL, f"{check_dataset}: the card's CCE "
            f"Recall@20 {got[0]['recall']} is {diff} from the CPU's "
            f"{want[0]['recall']} (tol {CCE_RECALL_TOL})")
    res["seconds"] = time.perf_counter() - t0
    log(f"cce: {res}")
    return res


# ---------------------------------------------------------------------------
# the recsys architectures at full published width
# ---------------------------------------------------------------------------
# (arch, shape, timed requests or AdamW steps after one untimed warm-up)
ARCH_CELLS = (("dlrm-mlperf-baco", "serve_p99", 20),
              ("dlrm-mlperf-baco", "serve_bulk", 5),
              ("dlrm-mlperf-baco", "retrieval_cand", 5),
              ("wide-deep-baco", "serve_p99", 20),
              ("wide-deep-baco", "train_batch", 5),
              ("sasrec-baco", "serve_p99", 20),
              ("sasrec-baco", "train_batch", 5),
              ("bert4rec-baco", "serve_p99", 20))
# the cell whose recorded call gives dot_interaction's and flash_attention's
# lead row on the kernels line (the other kernels list the arch path's
# rows beside their own lead rows)
ARCH_MAIN = {"dot_interaction": "dlrm-mlperf-baco:serve_bulk",
             "flash_attention": "sasrec-baco:train_batch"}


def count_state() -> dict:
    """Every launch counter, as (wrapper, attribute) -> value."""
    fns = counted_kernels()
    state = {(fn, "launches"): fn.launches for fn in fns.values()}
    fa, eb = fns["flash_attention"], fns["embedding_bag"]
    for fn, attr in ((fa, "launches_tc"), (fa, "launches_cc"),
                     (eb, "launches_weighted"), (eb, "launches_16")):
        state[(fn, attr)] = getattr(fn, attr)
    return state


def set_count_state(state: dict) -> None:
    for (fn, attr), value in state.items():
        setattr(fn, attr, value)


def gather_sum_inputs(g, dest, src, num_rows) -> tuple:
    """The CSR gather-sum's arguments in ``scatter_rows(g, dest, src,
    num_rows)`` (the lookups' backward): its stable sort by ``dest``."""
    import importlib
    eb = importlib.import_module("repro_torch.kernels.embedding_bag")
    import torch
    dest_sorted, perm = torch.sort(dest.long(), stable=True)
    return g, src[perm].int(), eb._ptr(dest_sorted, num_rows)


def _same_call(a, kw, out) -> tuple:
    return a, kw, out


def _scatter_rows_call(a, kw, out) -> tuple:
    return gather_sum_inputs(*a, **kw), {}, out


def _segment_sum_call(a, kw, out) -> tuple:
    """``schnet._SegmentSum.forward(ctx, x, seg, perm, ptr)``'s kernel
    call (and ``transformer._Combine.forward``'s, the same signature)."""
    _, x, _, perm, ptr = a
    return (x, perm, ptr), {}, out


def _gather_grad_call(a, kw, out) -> tuple:
    """``schnet._Gather.backward(ctx, g)``'s kernel call (and
    ``transformer._Gather.backward``'s)."""
    ctx, g = a
    perm, ptr = ctx.saved_tensors
    return (g.contiguous(), perm, ptr), {}, out[0]


class UnpackedOnce:
    """An autograd ``ctx`` whose saved tensors are unpacked once, for a
    backward and a check that both read them (a checkpointed block's
    saved tensors may be unpacked only once)."""

    def __init__(self, ctx):
        self._ctx = ctx
        self.saved_tensors = ctx.saved_tensors

    def __getattr__(self, name):
        return getattr(self._ctx, name)


@contextlib.contextmanager
def first_calls(check):
    """Inside the block, the first call of each kernel wrapper on the
    recsys, LM and GNN paths (codebook_lookup as the lookups call it, the
    CSR gather-sum as their backward's ``scatter_rows`` calls it and as
    SchNet's segment sum and gather gradient call it, dot_interaction and
    flash_attention as the models call them) is followed by
    ``check(name, args, kwargs, out)`` on the very tensors the path
    passed the kernel, with every launch counter restored after it:
    launches made to check or time a kernel do not count. SchNet's two
    calls are named ``embedding_bag:segment_sum`` and
    ``embedding_bag:gather_grad``, the MoE's token combine and its
    dispatch gather's gradient ``embedding_bag:moe_combine`` and
    ``embedding_bag:moe_gather_grad``."""
    import repro_torch.kernels.ops as ops
    import repro_torch.models.recsys as rs
    import repro_torch.models.schnet as sn
    import repro_torch.models.transformer as tf

    targets = ((ops, "codebook_lookup", "codebook_lookup", _same_call),
               (ops, "scatter_rows", "embedding_bag", _scatter_rows_call),
               (rs, "_dot_kernel", "dot_interaction", _same_call),
               (rs, "_flash_kernel", "flash_attention", _same_call),
               (sn._SegmentSum, "forward", "embedding_bag:segment_sum",
                _segment_sum_call),
               (sn._Gather, "backward", "embedding_bag:gather_grad",
                _gather_grad_call),
               (tf._Combine, "forward", "embedding_bag:moe_combine",
                _segment_sum_call),
               (tf._Gather, "backward", "embedding_bag:moe_gather_grad",
                _gather_grad_call))
    seen, saved = set(), []
    for obj, attr, name, call in targets:
        raw = vars(obj)[attr]              # a class keeps a staticmethod
        saved.append((obj, attr, raw))

        def wrap(*a, _orig=getattr(obj, attr), _name=name, _call=call,
                 _backward=attr == "backward", **kw):
            if _backward:                  # the check reads saved tensors too
                a = (UnpackedOnce(a[0]),) + a[1:]
            out = _orig(*a, **kw)
            if _name not in seen:
                seen.add(_name)
                state = count_state()
                check(_name, *_call(a, kw, out))
                set_count_state(state)
            return out
        setattr(obj, attr, staticmethod(wrap)
                if isinstance(raw, staticmethod) else wrap)
    try:
        yield seen
    finally:
        for obj, attr, raw in saved:
            setattr(obj, attr, raw)


def arch_kernel_row(name: str, a, kw, out) -> dict:
    """One recorded call of a kernel (``name``, or ``name:role``) on a
    model path held against its
    plain version on the same device tensors (codebook_lookup and the
    CSR gather-sum bitwise; dot_interaction and flash_attention at
    ``check_close``'s f32 tolerance), and timed beside its plain version
    and one PyTorch library call, with its bound from this call's inputs
    (the rows a lookup reads, not the whole codebook)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import route

    name = name.split(":")[0]                 # a role after the kernel
    kernel = counted_kernels()[name]          # the unwrapped wrapper
    if name == "codebook_lookup":
        z, idx = a
        binary = kw.get("binary", False)
        want = ref.codebook_lookup(z, idx, binary=binary)
        require(torch.equal(out, want), "codebook_lookup on the recsys "
                "path is not bitwise its plain version")
        b, h = idx.shape
        d = z.shape[1]
        bms, by = kcost.bound(kcost.codebook_lookup(
            z, idx, rows=int(torch.unique(idx).numel())))
        ixl = idx.long()
        wide = z.dtype == torch.float32
        # a 16-bit lookup (the LM token embedding, H = 1): `table[ids]`
        library = ((lambda: z[ixl].sum(1)) if wide or h > 1
                   else (lambda: z[ixl[:, 0]]))
        row = {"shape": f"B={b} H={h} K={z.shape[0]} d={d}"
                        + ("" if wide else f" {str(z.dtype)[6:]}"),
               "max_abs_err": 0.0,
               "plain_ms": time_ms(lambda: ref.codebook_lookup(
                   z, idx, binary=binary), iters=10),
               "library_ms": time_ms(library, iters=10)}
    elif name == "embedding_bag":
        src, idx, ptr = a[:3]
        weight = a[3] if len(a) > 3 else kw.get("weight")
        want = ref.csr_gather_sum(src, idx, ptr, weight)
        require(torch.equal(out, want), "the CSR gather-sum on the recsys "
                "path is not bitwise its plain version")
        n_seg, d = out.shape
        nnz = int(ptr[-1])
        seg = torch.repeat_interleave(
            torch.arange(n_seg, device=src.device),
            (ptr[1:] - ptr[:-1]).long())
        idl = idx[:nnz].long()
        es = src.element_size()
        bms, by = kcost.bound(kcost.csr_gather_sum(src, idx, ptr, weight, nnz=nnz,
                                             rows=nnz))
        if src.dtype == torch.float32 or src.shape[0] != nnz:
            acc = torch.zeros_like(out)
            library = lambda: acc.zero_().index_add_(  # noqa: E731
                0, seg, src[idl])
        else:
            # a 16-bit lookup's gradient (each cotangent row used once):
            # f32 sums into a dense table, one cast
            rows_of = torch.empty_like(seg)
            rows_of[idl] = seg                # each cotangent row's id
            library = lambda: torch.zeros(  # noqa: E731
                n_seg, d, device=src.device).index_add_(
                    0, rows_of, src.float()).to(src.dtype)
        row = {"shape": f"nnz={nnz} S={n_seg} d={d}"
                        + ("" if es == 4 else f" {str(src.dtype)[6:]}"),
               "max_abs_err": 0.0,
               "plain_ms": time_ms(lambda: ref.csr_gather_sum(
                   src, idx, ptr, weight), iters=10),
               "library_ms": time_ms(library, iters=10)}
    elif name == "dot_interaction":
        (x,) = a
        err = check_close(out, ref.dot_interaction(x), x.dtype,
                          "dot_interaction on the recsys path")
        b, f, d = x.shape
        bms, by = kcost.bound(kcost.dot_interaction(x))
        i, j = torch.tril_indices(f, f, -1, device=x.device)
        row = {"shape": f"B={b} F={f} d={d} float32", "max_abs_err": err,
               "plain_ms": time_ms(lambda: ref.dot_interaction(x),
                                   iters=10),
               "library_ms": time_ms(
                   lambda: torch.bmm(x, x.transpose(1, 2))[:, i, j],
                   iters=10)}
    else:
        q, k, v = a
        causal = kw["causal"]
        require(route(q.dtype, q.shape[-1]) == "cc",
                "the recsys attention is not on the CUDA-core route")
        err = check_close(out, ref.flash_attention(q, k, v, causal=causal),
                          q.dtype, "flash_attention on the recsys path")
        b, h, sq, d = q.shape
        bms, by = kcost.bound(kcost.flash_attention(q, k, v, causal=causal))
        row = {"shape": f"B={b} H={h} S={sq} d={d} float32 "
                        f"{'causal' if causal else 'full'}",
               "max_abs_err": err,
               "plain_ms": time_ms(lambda: ref.flash_attention(
                   q, k, v, causal=causal), iters=10),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=causal), iters=10)}
    row.update(ms=time_ms(lambda: kernel(*a, **kw), iters=10), bound_ms=bms,
               bound_by=by)
    return row


def arch_out_shape(cell) -> tuple:
    """The shape a serve/retrieval cell's scores must have: one per
    example (DLRM, Wide&Deep serve), one per candidate (their retrieval),
    [B, C] (SASRec, BERT4Rec)."""
    b = cell.args[-1]
    if "seq" in b:
        return tuple(b["candidates"].shape)
    if cell.kind == "retrieval":
        return (b["candidates"].shape[0],)
    return (b["sparse"].shape[0],)


def arch_cell(arch: str, shape: str, n: int) -> dict:
    """One recsys cell at the full published width on the card:
    serve/retrieval through ``ArchSession``, train through
    ``build_cell``'s AdamW step. Counts zeroed just before the
    warm-up and read just after the last call; the warm-up's first call
    of each kernel is held against its plain version and timed
    (:func:`first_calls`). Peak device memory from a reset at the cell's
    start (``peak_gb``, checks included) and from a reset after the
    warm-up (``peak_calls_gb``, the timed calls only)."""
    import gc

    import torch

    from repro_torch.launch.steps import build_cell
    from repro_torch.models import recsys as rs
    from repro_torch.obs import LatencyRecorder, clock
    from repro_torch.serve import ArchSession

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train = shape == "train_batch"
    if train:
        cell = build_cell(arch, shape, smoke=False, device="cuda")
        flat = rs.flat_params(cell.args[0])
        before = {k: p.clone() for k, p in flat.items()}
    else:
        session = ArchSession(arch, shape, smoke=False, device="cuda")
        cell = session.cell
    sync("cuda")
    build_s = time.perf_counter() - t0
    kernels = {}

    def check(name, a, kw, out):
        kernels[name] = arch_kernel_row(name, a, kw, out)

    zero_counts()
    losses = []
    with first_calls(check):
        if train:
            losses.append(float(cell.fn(*cell.args)[2]))
        else:
            session.warmup()
    torch.cuda.reset_peak_memory_stats()
    lat = LatencyRecorder()
    for _ in range(n):
        if train:
            sync("cuda")
            t = clock.now()
            loss = cell.fn(*cell.args)[2]
            sync("cuda")
            lat.record(clock.ms_between(t, clock.now()))
            losses.append(float(loss))
        else:
            out = session()
    sync("cuda")
    launches = {k: v for k, v in launch_counts().items() if v}
    routes = flash_routes()
    peak_calls = torch.cuda.max_memory_allocated() / 1e9
    label = f"{arch}:{shape}"
    res = {"cell": label, "kind": cell.kind, "calls": n + 1,
           "build_s": build_s, "launches": launches,
           "launches_per_call": {k: v / (n + 1) for k, v in launches.items()},
           "flash_routes": routes, "kernels": kernels}
    if train:
        require(all(map(math.isfinite, losses)),
                f"{label}: a loss is not finite: {losses}")
        changed = [k for k, p in rs.flat_params(cell.args[0]).items()
                   if not torch.equal(p, before[k])]
        require(len(changed) == len(before), f"{label}: params left "
                f"unchanged by {n + 1} steps: "
                f"{sorted(set(before) - set(changed))[:5]}")
        res.update(losses=losses, params_changed=len(changed),
                   batch=int(next(iter(cell.args[3].values())).shape[0]),
                   **lat.summary())
        del before, flat
    else:
        want = arch_out_shape(cell)
        require(tuple(out.shape) == want and bool(torch.isfinite(out).all()),
                f"{label}: scores {tuple(out.shape)} (want {want}) or not "
                f"finite")
        res.update(out_shape=list(want), **session.stats())
        del session, out
    need = {"codebook_lookup", "dot_interaction"} if arch.startswith(
        "dlrm") else {"codebook_lookup"}
    if arch.startswith(("sasrec", "bert4rec")):
        need |= {"flash_attention"}
    if train:
        need |= {"embedding_bag"}
    for name in sorted(need):
        require(launches.get(name, 0) > 0, f"{name} never ran on {label}")
        require(name in kernels, f"{name}: no call recorded on {label}")
    require(routes["cc"] > 0 or "flash_attention" not in need,
            f"{label}: flash_attention ran no CUDA-core launch")
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["peak_calls_gb"] = peak_calls
    del cell
    gc.collect()
    torch.cuda.empty_cache()
    log(f"arch {label}: {res}")
    return res


def arch_small_reference() -> dict:
    """Each -baco arch's smoke cells on the card against the port's CPU
    path (held against the JAX package by the CPU tests) on the same
    params: serve scores and one train step's loss and params within
    rtol 1e-4 / atol 1e-5."""
    import torch

    from repro_torch.launch.steps import build_cell
    from repro_torch.models import recsys as rs
    from repro_torch.training.optimizer import adamw

    out = {}
    for arch in ("dlrm-mlperf-baco", "wide-deep-baco", "sasrec-baco",
                 "bert4rec-baco"):
        for shape in ("serve_p99", "retrieval_cand", "train_batch"):
            cpu = build_cell(arch, shape, smoke=True, device="cpu")
            gpu = build_cell(arch, shape, smoke=True, device="cuda")
            params = _to(cpu.args[0], "cuda")
            args = (params,) + tuple(gpu.args[1:])
            if cpu.kind == "train":
                args = (params, adamw(lr=1e-3).init(rs.flat_params(params)),
                        gpu.args[2], gpu.args[3])
            got, want = gpu.fn(*args), cpu.fn(*cpu.args)
            if cpu.kind == "train":
                pairs = [(got[2], want[2])] + [
                    (rs.flat_params(got[0])[k], v)
                    for k, v in rs.flat_params(want[0]).items()]
            else:
                pairs = [(got, want)]
            err = 0.0
            for g, w in pairs:
                g = g.detach().cpu()
                require(torch.allclose(g, w, rtol=1e-4, atol=1e-5),
                        f"{arch}:{shape} smoke: the card differs from the "
                        f"CPU path")
                err = max(err, float((g - w).abs().max()))
            out[f"{arch}:{shape}"] = err
    log(f"arch smoke cells, card == CPU path (max |err|): {out}")
    return out


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device, copy=True)


def arch_rows(run: dict, name: str) -> dict:
    """The arch phase's recorded-call rows of one kernel, by cell."""
    return {c["cell"]: c["kernels"][name] for c in run["arch"]["cells"]
            if name in c["kernels"]}


def arch_entry(run: dict, name: str, bench_launches: int) -> dict:
    """A kernel's kernels-line fields from the arch phase: its launches
    (the arch phase's and the kernel bench's), and the row of its
    :data:`ARCH_MAIN` cell's recorded call."""
    rows = arch_rows(run, name)
    main = rows[ARCH_MAIN[name]]
    arch_n = run["arch"]["launches"].get(name, 0)
    mesh_n = run["arch_mesh"]["launches"].get(name, 0)
    return {"launches": arch_n + mesh_n + bench_launches,
            "launches_by_path": {"arch": arch_n, "arch_mesh": mesh_n,
                                 "kernel_bench": bench_launches},
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "shape")},
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            "arch_path": rows}


def arch_path() -> dict:
    """The recsys architectures through their entry points at the full
    published width on the card: ``ArchSession`` for the serve and
    retrieval cells, ``build_cell``'s AdamW step for the train cells
    (:func:`arch_cell` each), then the smoke cells on the card against
    the CPU path. Each cell's kernels must have run."""
    t0 = time.perf_counter()
    res = {"cells": [arch_cell(a, s, n) for a, s, n in ARCH_CELLS]}
    total = {}
    for c in res["cells"]:
        for k, v in c["launches"].items():
            total[k] = total.get(k, 0) + v
    res["launches"] = total
    res["small_reference"] = arch_small_reference()
    res["seconds"] = time.perf_counter() - t0
    log(f"arch phase: {res['seconds']:.1f} s, launches {total}")
    return res


# the LM cells at their published widths, each cut to one H100
# (launch.steps.LM_ONE_CARD), with the requests each serves after its
# warm-up: the dense LMs, gemma's long_500k decode, the MoE LMs
LM_CELLS = (("gemma2-9b", "prefill_32k", 1),
            ("gemma3-12b", "prefill_32k", 1),
            ("qwen1.5-32b", "prefill_32k", 1),
            ("gemma2-9b", "decode_32k", 5),
            ("gemma3-12b", "decode_32k", 5),
            ("qwen1.5-32b", "decode_32k", 5),
            ("gemma3-12b", "long_500k", 5),
            ("gemma2-9b", "long_500k", 5),
            ("dbrx-132b", "decode_32k", 5),
            ("dbrx-132b", "prefill_32k", 1),
            ("kimi-k2-1t-a32b", "decode_32k", 5),
            ("kimi-k2-1t-a32b", "prefill_32k", 1))
# the full-width decode-after-prefill check: rows, prompt tokens, and the
# logit tolerance by cache dtype, and for the MoE LMs' bf16 stream (see
# lm_decode_after_prefill)
LM_CHECK_ROWS, LM_CHECK_PROMPT = 8, 64
LM_CHECK_ATOL = {"bfloat16": 0.08, "float8_e4m3fn": 0.25,
                 "bfloat16 moe": 0.15}


def lm_config(arch: str, shape: str):
    """The full config of an LM cell, at its one-card depth."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.steps import LM_ONE_CARD

    cfg = get_arch(arch).full_config()
    n = LM_ONE_CARD[(arch, shape)].get("n_layers")
    return cfg if n is None else dataclasses.replace(cfg, n_layers=n)


def lm_decode_after_prefill(params, cfg) -> dict:
    """At full width on the cell's params: prefill ``S`` prompt tokens,
    decode token S, against a prefill of S + 1 tokens (``LM_CHECK_ROWS``
    rows of tokens uniform over the vocabulary). Decode reads K/V rounded
    to the cache's dtype (bf16, or fp8 for qwen) and, for gemma, rounds
    its attention output to bf16, where the longer prefill attends to
    the unrounded f32 K/V: the logits may differ by those roundings,
    carried through every layer. Gates: every logit finite; max |diff|
    within ``LM_CHECK_ATOL`` of the cache dtype (3x and 2.2x the readings
    on an H100 80GB HBM3: 0.027 for bf16, 0.113 for fp8, on logits of
    standard deviation ~1); the greedy token equal in every row whose
    top two logits (of the longer prefill) lie more than twice the
    measured |diff| apart, and in at least one row. Two planted faults
    must fail the |diff| gate: decoding at ``pos`` S - 1 (the last
    prompt slot overwritten, the mask one slot short, RoPE one back) and
    at S + 1 (RoPE one ahead); on the same card they read 0.96-1.35
    (bf16) and 0.34-0.64 (fp8).

    A MoE's capacity depends on the tokens a call carries, so at the
    published capacity factor the S- and (S+1)-token prefills and the
    8-token decode would drop different assignments: the check runs on
    the cell's params with ``capacity_factor = n_experts / top_k``
    (cap == t: nothing drops), and reports the assignments the published
    capacity drops on the (S+1)-token prefill's tokens (:func:`moe_drops`;
    on the card 1,245 of 16,640 for dbrx-132b's 8 layers, 644 of 4,160
    for kimi-k2's one, at cap 14 against a mean load of 10.8). Its
    tolerance, 0.15, is 3x the larger reading on an H100 80GB HBM3
    (0.0508 for dbrx-132b, 0.0469 for kimi-k2: the MoE's logits move
    more than a dense model's when the rounded K/V shifts a router's
    near-tie); its planted faults read 1.35-2.97."""
    import torch

    from repro_torch.models import transformer as T

    published = cfg
    if cfg.moe is not None:
        no_drop = cfg.moe.n_experts / cfg.moe.top_k
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=no_drop))
    s, b = LM_CHECK_PROMPT, LM_CHECK_ROWS
    dev = params["embed"].device
    g = torch.Generator(device=dev).manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=g,
                        device=dev, dtype=torch.int32)

    def decode_at(pos):
        _, cache = T.prefill(params, {"tokens": tok[:, :s]}, cfg,
                             max_seq=s + 1)
        dec, _ = T.decode_step(params, cache, {
            "tokens": tok[:, s:s + 1],
            "pos": torch.tensor(pos, dtype=torch.int32, device=dev)}, cfg)
        return dec

    with torch.inference_mode():
        full, _ = T.prefill(params, {"tokens": tok}, cfg, max_seq=s + 1)
        dec = decode_at(s)
        planted = {f"pos {p - s:+d}": float((decode_at(p) - full).abs().max())
                   for p in (s - 1, s + 1)}
        drops = (None if cfg.moe is None
                 else moe_drops(params, tok, published, cfg))
    kv = cfg.kv_cache_dtype or cfg.dtype
    atol = LM_CHECK_ATOL[kv + (" moe" if cfg.moe is not None else "")]
    require(bool(torch.isfinite(full).all() & torch.isfinite(dec).all()),
            f"{cfg.name}: decode-after-prefill logits not finite")
    diff = float((dec - full).abs().max())
    top2 = full.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).cpu().tolist()
    same = (dec.argmax(-1) == full.argmax(-1)).cpu().tolist()
    binding = [gp > 2 * diff for gp in gap]
    res = {"rows": b, "prompt": s, "kv_dtype": kv, "max_abs_diff": diff,
           "atol": atol, "logit_absmax": float(full.abs().max()),
           "logit_std": float(full.float().std()), "greedy_equal": same,
           "top2_gap": gap, "greedy_rows_checked": sum(binding),
           "planted_max_abs_diff": planted}
    if drops is not None:
        res["moe"] = drops
    require(diff <= atol, f"{cfg.name}: decode after prefill differs from "
            f"the longer prefill by {diff} (atol {atol}): {res}")
    require(any(binding), f"{cfg.name}: every row is a near-tie, the "
            f"greedy gate checks nothing: {res}")
    for ok, bind in zip(same, binding):
        require(ok or not bind, f"{cfg.name}: greedy token differs "
                f"beyond a near-tie: {res}")
    for what, d in planted.items():
        require(d > atol, f"{cfg.name}: a planted fault ({what}) passes "
                f"the decode-after-prefill gate: {res}")
    log(f"{cfg.name} decode after prefill: {res}")
    return res


def moe_drops(params, tok, cfg, no_drop_cfg) -> dict:
    """The assignments a prefill of ``tok`` drops at ``cfg``'s (the
    published) capacity and at ``no_drop_cfg``'s, summed over its MoE
    layers (each layer's ``moe_route`` wrapped to count ``~keep``)."""
    import torch

    from repro_torch.models import transformer as T

    t = tok.numel()
    res = {}
    orig = T.moe_route
    for label, c in (("published", cfg), ("check", no_drop_cfg)):
        counts = []

        def route(xt, router, moe, *a, _counts=counts):
            r = orig(xt, router, moe, *a)
            _counts.append((~r.keep).sum())
            return r
        T.moe_route = route
        try:
            T.prefill(params, {"tokens": tok}, c, max_seq=tok.shape[1])
        finally:
            T.moe_route = orig
        res[label] = {"capacity_factor": c.moe.capacity_factor,
                      "cap": T.moe_capacity(t, c.moe),
                      "dropped": int(torch.stack(counts).sum()),
                      "assignments": len(counts) * t * c.moe.top_k}
    res["tokens"] = t
    res["mean_load"] = t * cfg.moe.top_k / cfg.moe.n_experts
    require(res["check"]["dropped"] == 0 and res["check"]["cap"] == t,
            f"{cfg.name}: the no-drop check capacity dropped: {res}")
    return res


def lm_step_bytes(cell, cfg) -> int:
    """Bytes one decode step must read: every param (the token embedding
    only at the batch's rows, unless the head is tied to it and reads it
    all; a MoE's every expert, as the batched expert GEMMs read them) and
    the whole cache."""
    from repro_torch.models.recsys import flat_params

    params, cache, b = cell.args
    size = lambda t: t.numel() * t.element_size()  # noqa: E731
    total = sum(map(size, flat_params(params).values()))
    total += sum(map(size, cache.values()))
    if not cfg.tie_embed:
        emb = params["embed"]
        total -= size(emb) - b["tokens"].numel() * size(emb[0])
    return total


def finite_cache(cache: dict) -> bool:
    """Every K/V entry of a cache finite, read a block at a time (an f32
    copy of a whole fp8 cache would be four times its size)."""
    import torch

    return all(bool(torch.isfinite(t[i].float()).all())
               for t in cache.values() for i in range(t.shape[0]))


def lm_cell(arch: str, shape: str, n: int) -> dict:
    """One LM cell at full width on the card through ``ArchSession`` (one
    card's cut): counts zeroed just before the warm-up and read just
    after the last request; the token lookup (codebook_lookup's 16-bit
    kernel) must launch once a request and, for a MoE, the 16-bit CSR
    gather-sum (the token combine) once a MoE layer a request, and no
    other time; the warm-up's first token lookup and first combine held
    bitwise against their plain versions and timed (:func:`first_calls`);
    p50/p99, tokens/s, peak device bytes from a reset after the warm-up
    (at most ``PEAK_SHARE`` of the card). A prefill cell's cache must be
    finite (for qwen's fp8 cache, no K/V past the cast's NaN bound,
    ``transformer.to_kv``). A decode cell reports the
    bytes one step must read (:func:`lm_step_bytes`) and that time at
    the HBM rate beside its p50, and runs :func:`lm_decode_after_prefill`
    on its params."""
    import gc

    import torch

    from repro_torch.kernels import cost as kcost
    from repro_torch.launch.steps import LM_ONE_CARD
    from repro_torch.serve import ArchSession

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    session = ArchSession(arch, shape, smoke=False, device="cuda",
                          **LM_ONE_CARD[(arch, shape)])
    sync("cuda")
    build_s = time.perf_counter() - t0
    kernels = {}

    def check(name, a, kw, out):
        kernels[name] = arch_kernel_row(name, a, kw, out)

    zero_counts()
    t0 = time.perf_counter()
    with first_calls(check):
        session.warmup()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    for _ in range(n):
        out = session()
    sync("cuda")
    launches = {k: v for k, v in launch_counts().items() if v}
    launches_16 = counted_kernels()["embedding_bag"].launches_16
    peak_calls = torch.cuda.max_memory_allocated() / 1e9
    label = f"{arch}:{shape}"
    cell = session.cell
    logits = out[0]
    b = cell.args[-1]["tokens"].shape[0]
    cfg = lm_config(arch, shape)
    want_16 = (n + 1) * (cfg.n_layers if cfg.moe is not None else 0)
    require(tuple(logits.shape) == (b, cfg.vocab_size)
            and logits.dtype == torch.float32
            and bool(torch.isfinite(logits).all()),
            f"{label}: logits {tuple(logits.shape)} {logits.dtype} (want "
            f"({b}, {cfg.vocab_size}) float32) or not finite")
    require(launches.get("codebook_lookup", 0) == n + 1,
            f"{label}: codebook_lookup launched {launches} times in "
            f"{n + 1} requests (want one a request)")
    require("codebook_lookup" in kernels,
            f"codebook_lookup: no call recorded on {label}")
    require(launches.get("embedding_bag", 0) == launches_16 == want_16,
            f"{label}: the CSR gather-sum launched "
            f"{launches.get('embedding_bag', 0)} times ({launches_16} "
            f"16-bit) in {n + 1} requests, want {want_16} (one a MoE "
            f"layer a request)")
    require(want_16 == 0 or "embedding_bag:moe_combine" in kernels,
            f"embedding_bag: no MoE combine recorded on {label}")
    res = {"cell": label, "kind": cell.kind, "calls": n + 1,
           "reduced": list(cell.reduced),
           "build_s": build_s, "warmup_s": warm_s, "batch": b,
           "seq_len": int(cell.args[-1]["tokens"].shape[1]
                          if cell.kind == "prefill"
                          else cell.args[1]["k_global"].shape[3]),
           "n_layers": cfg.n_layers, "launches": launches,
           "launches_bf16_gather_sum": launches_16,
           "launches_per_call": {k: v / (n + 1)
                                 for k, v in launches.items()},
           "kernels": kernels, **session.stats(),
           "peak_calls_gb": peak_calls}
    if cell.kind == "prefill":
        require(finite_cache(out[1]),
                f"{label}: the cache prefill wrote is not finite")
    if cell.kind == "decode":
        res["step_bytes"] = lm_step_bytes(cell, cfg)
        res["step_bytes_ms"] = kcost.bound(kcost.Cost(res["step_bytes"]))[0]
        res["profile"] = profile_lm_request(session, label)
        cache = out[1]
        require(all(bool(torch.isfinite(cache[k][:, :, :, -1].float()).all())
                    for k in cache if k.endswith("global")),
                f"{label}: the cache slot decode wrote is not finite")
        res["decode_after_prefill"] = lm_decode_after_prefill(
            cell.args[0], cfg)
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del session, cell, out, logits
    gc.collect()
    torch.cuda.empty_cache()
    log(f"lm {label}: {res}")
    require_peak(label, res["peak_gb"] * 1e9)
    return res


# the full-width LM train cells (their LM_ONE_CARD cuts), and the timed
# steps after one untimed warm-up: the dense LMs (one timed step of
# gemma's 15-19 s) and a MoE
LM_TRAIN_CELLS = (("gemma2-9b", "train_4k", 1), ("gemma3-12b", "train_4k", 1),
                  ("qwen1.5-32b", "train_4k", 2))
LM_MOE_TRAIN_CELL = ("dbrx-132b", "train_4k", 2)
# the cell one card cannot hold, with the reckoning chip_smoke prints
LM_NOT_RUN = ("kimi-k2-1t-a32b", "train_4k")
# the share of the card's memory a full-width cell's peak may take
PEAK_SHARE = 0.85


def recorded_calls(calls: dict):
    """``first_calls``'s check that keeps a copy of each kernel's first
    call (its inputs and output) to hold and time after the run."""
    import torch

    def keep(name, a, kw, out):
        calls[name] = (tuple(t.clone() if torch.is_tensor(t) else t
                             for t in a), dict(kw), out.clone())
    return keep


def held_rows(calls: dict) -> dict:
    """Each recorded first call held against its plain version and timed
    (``arch_kernel_row``), its launches not counted."""
    state = count_state()
    rows = {name: arch_kernel_row(name, *c) for name, c in calls.items()}
    set_count_state(state)
    return rows


def require_peak(label: str, peak_bytes: float) -> None:
    import torch
    total = torch.cuda.get_device_properties(0).total_memory
    require(peak_bytes <= PEAK_SHARE * total,
            f"{label}: peak {peak_bytes / 1e9:.2f} GB leaves less than "
            f"{1 - PEAK_SHARE:.0%} of the card's {total / 1e9:.2f} GB free")


def lm_train_cell(arch: str, shape: str, n: int,
                  every_step: bool = True) -> dict:
    """An LM's train cell at full width through ``build_cell`` at its
    one-card cut (``LM_ONE_CARD``: gemma2-9b at 8 of 42 layers and
    gemma3-12b at 6 of 48 with the f32 gradient accumulator, qwen1.5-32b
    at 5 of 64 and dbrx-132b at 1 of 40 with the bf16 one; 8 sequences of
    4,096 tokens, one a microbatch), on a fixed batch: one
    warm-up step and ``n`` timed steps. Counts zeroed just before the
    warm-up and read just after the last step: the token lookup must
    launch once a microbatch, and the CSR gather-sum's bf16
    instantiation once a microbatch for the token lookup's backward and,
    for a MoE, three times a MoE layer a microbatch (the token combine in
    the forward and again in the block's recompute, the dispatch
    gather's gradient in the backward), and no other time. The loss must
    be finite and fall at every step (``every_step``), or else fall at
    the first update and end below where it began: at dbrx-132b's one
    layer AdamW's first steps at lr 3e-4 move every one of the 1.23e9
    embedding and head weights by about lr, and the third loss rose
    above the second on the card (12.010, 8.123, 8.859: an overshoot
    of the repeated batch, not a wrong gradient; the CPU tests hold the
    gradients against ``jax.value_and_grad``). The warm-up's first
    backward call
    of the lookup (the first microbatch's cotangent and token ids), first
    lookup, first combine and first dispatch-gather gradient are kept,
    then held bitwise against their plain versions and timed once the
    cell's tensors are freed (L2 flushed; a gather-sum beside ``zeros(S,
    d, f32).index_add_(0, ids, g.float()).to(bf16)``, 4.03 GB of f32 at
    gemma3's 262,144 x 3,840). Step ms, tokens/s and the peak GB from the
    build on and from a reset after the warm-up, which must both leave
    15% of the card free."""
    import gc

    import torch

    from repro_torch.launch.steps import LM_ONE_CARD, build_cell
    from repro_torch.obs import clock

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    label = f"{arch}:{shape}"
    t0 = time.perf_counter()
    cell = build_cell(arch, shape, smoke=False, device="cuda",
                      **LM_ONE_CARD[(arch, shape)])
    sync("cuda")
    build_s = time.perf_counter() - t0
    calls = {}
    zero_counts()
    t0 = time.perf_counter()
    with first_calls(recorded_calls(calls)):
        losses = [float(cell.fn(*cell.args)[2])]
    warm_s = time.perf_counter() - t0
    peak_warm = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(n):
        sync("cuda")
        t = clock.now()
        loss = float(cell.fn(*cell.args)[2])
        step_ms.append(clock.ms_between(t, clock.now()))
        losses.append(loss)
    launches = {k: v for k, v in launch_counts().items() if v}
    launches_16 = counted_kernels()["embedding_bag"].launches_16
    peak = torch.cuda.max_memory_allocated()
    tokens = cell.args[2]["tokens"]
    micro = int(re.search(r"microbatches=(\d+)", cell.notes).group(1))
    res = {"cell": label, "reduced": list(cell.reduced), "notes": cell.notes,
           "steps": n + 1, "microbatches": micro,
           "tokens_per_step": int(tokens.numel()), "build_s": build_s,
           "warmup_s": warm_s, "step_ms": step_ms,
           "step_ms_median": statistics.median(step_ms),
           "losses": losses, "launches": launches,
           "launches_bf16_gather_sum": launches_16,
           "peak_gb": peak / 1e9, "peak_warmup_gb": peak_warm / 1e9}
    res["tokens_per_s"] = tokens.numel() / (res["step_ms_median"] / 1e3)
    del cell, tokens
    gc.collect()
    torch.cuda.empty_cache()
    require(all(map(math.isfinite, losses)),
            f"{label}: a loss is not finite: {losses}")
    if every_step:
        require(all(b < a for a, b in zip(losses, losses[1:])),
                f"{label}: the loss did not fall at every step on the "
                f"repeated batch: {losses}")
    else:
        require(losses[1] < losses[0] and losses[-1] < losses[0],
                f"{label}: the loss did not fall at the first update and "
                f"end below its start on the repeated batch: {losses}")
    want = micro * (n + 1)
    cfg = lm_config(arch, shape)
    moe = cfg.moe is not None
    want_16 = want * (1 + (3 * cfg.n_layers if moe else 0))
    res["launches_bf16_gather_sum_want"] = want_16
    require(launches_16 == want_16
            and launches.get("embedding_bag") == want_16,
            f"{label}: the bf16 CSR gather-sum launched {launches_16} times "
            f"({launches}), want {want_16}: one a microbatch"
            + (", and three a MoE layer a microbatch" if moe else ""))
    require(launches.get("codebook_lookup") == want,
            f"{label}: the token lookup launched "
            f"{launches.get('codebook_lookup')} times, want {want}")
    require_peak(label, max(peak, peak_warm))
    want_calls = {"codebook_lookup", "embedding_bag"}
    if moe:
        want_calls |= {"embedding_bag:moe_combine",
                       "embedding_bag:moe_gather_grad"}
    require(set(calls) == want_calls,
            f"{label}: recorded calls {sorted(calls)}")
    require(calls["embedding_bag"][0][0].dtype == torch.bfloat16,
            f"{label}: the lookup's backward is not bf16")
    res["kernels"] = held_rows(calls)
    del calls
    gc.collect()
    torch.cuda.empty_cache()
    log(f"lm train {label}: {res}")
    return res


def profile_lm_request(session, label: str) -> dict:
    """One more request of a cell under ``torch.profiler`` (after its
    launch counts were read): device time by kernel, wall time, idle
    share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        session()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = device_times(prof, 1)
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    log(f"profile ({label}, one request): device busy {busy:.3f} ms of "
        f"{wall_ms:.3f} ms")
    for name, ms in top:
        log(f"  {ms:9.4f} ms  {100 * ms / max(busy, 1e-9):5.1f}%  {name}")
    return {"device_ms": busy, "wall_ms": wall_ms,
            "idle_share": 1.0 - busy / wall_ms, "top_kernels_ms": dict(top)}


# the LM archs whose smoke cells the card holds against the CPU path
LM_ARCHS = ("gemma2-9b", "gemma3-12b", "qwen1.5-32b", "dbrx-132b",
            "kimi-k2-1t-a32b")


def lm_small_reference(device: str = "cuda") -> dict:
    """Each LM's smoke cells (the dense LMs and the MoE LMs) on the card
    against the port's CPU path (held against the JAX package by the CPU
    tests) on the same params and inputs: prefill and decode logits and
    cache, and one AdamW step's loss and params, within rtol 1e-4 / atol
    1e-5 (f32); a bf16 variant of gemma2's and qwen's smoke config,
    prefill within rtol 2e-2 / atol 4e-2 (bf16 roundings after sums in
    another order), with the reference's residual dtype (f32 for gemma2,
    bf16 for qwen); a bf16 train step of each
    (:func:`lm_bf16_train_reference`)."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import recsys as rs
    from repro_torch.models import transformer as T

    out = {}

    def hold(pairs, label, rtol, atol):
        err = 0.0
        for g, w in pairs:
            g = g.detach().cpu().float()
            w = w.detach().float()
            require(torch.allclose(g, w, rtol=rtol, atol=atol),
                    f"{label}: the card differs from the CPU path")
            err = max(err, float((g - w).abs().max()))
        out[label] = err

    for arch in LM_ARCHS:
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            cpu = build_cell(arch, shape, smoke=True, device="cpu")
            gpu = build_cell(arch, shape, smoke=True, device=device)
            args = tuple(_to(a, device) for a in cpu.args)
            got, want = gpu.fn(*args), cpu.fn(*cpu.args)
            if cpu.kind == "train":
                pairs = [(got[2], want[2])] + [
                    (rs.flat_params(got[0])[k], v)
                    for k, v in rs.flat_params(want[0]).items()]
            else:
                pairs = [(got[0], want[0])] + [(got[1][k], v)
                                               for k, v in want[1].items()]
            hold(pairs, f"{arch}:{shape}", 1e-4, 1e-5)
    for arch, stream in (("gemma2-9b", torch.float32),
                         ("qwen1.5-32b", torch.bfloat16)):
        cfg = dataclasses.replace(get_arch(arch).smoke_config(),
                                  dtype="bfloat16")
        params = T.init_params(torch.Generator().manual_seed(0), cfg)
        tok = torch.randint(0, cfg.vocab_size, (2, 16), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1))
        with torch.inference_mode():
            want = T.prefill(params, {"tokens": tok}, cfg, max_seq=16)
            got = T.prefill(_to(params, device), {"tokens": tok.to(device)},
                            cfg, max_seq=16)
            h = T._backbone(_to(params, device), tok.to(device), cfg,
                            T._positions(2, 16, device))
        require(h.dtype == stream, f"{arch} bf16: residual stream "
                f"{h.dtype}, want {stream}")
        hold([(got[0], want[0])] + [(got[1][k], v)
                                    for k, v in want[1].items()],
             f"{arch}:bf16 prefill", 2e-2, 4e-2)
    for arch in LM_ARCHS:
        out[f"{arch}:bf16 train"] = lm_bf16_train_reference(arch, device)
    log(f"lm smoke cells, card == CPU path (max |err|): {out}")
    return out


def lm_bf16_train_reference(arch: str, device: str) -> dict:
    """One bf16 train step of an LM's smoke config (the train_4k smoke
    shape: 4 sequences of 16 tokens) on the card against the port's CPU
    path on the same params and tokens: the loss within rtol 1e-2, every
    param's gradient within 8 bf16 ulps of its max |g| (bf16 GEMMs and
    roundings in another order; the CPU tests hold the same bound against
    ``jax.value_and_grad``). On the card the token lookup's backward is
    the bf16 CSR gather-sum, which must launch once, and for a MoE three
    times more a layer (the combine, its recompute, the dispatch
    gather's gradient)."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import recsys as rs
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_arch(arch).smoke_config(),
                              dtype="bfloat16")
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(2)
    b = {k: torch.randint(0, cfg.vocab_size, (4, 16), dtype=torch.int32,
                          generator=g) for k in ("tokens", "targets")}
    res = {}
    for dev in ("cpu", device):
        p = _to(params, dev)
        flat = rs.flat_params(p)
        leaves = [t.requires_grad_(True) for t in flat.values()]
        before = counted_kernels()["embedding_bag"].launches_16
        loss = T.train_loss(p, _to(b, dev), cfg)
        grads = torch.autograd.grad(loss, leaves)
        res[dev] = (float(loss.detach()), {k: x.detach().float().cpu()
                                  for k, x in zip(flat, grads)},
                    counted_kernels()["embedding_bag"].launches_16 - before)
    (l_cpu, g_cpu, _), (l_dev, g_dev, n16) = res["cpu"], res[device]
    want = 1 + (3 * cfg.n_layers if cfg.moe is not None else 0)
    require(n16 == want, f"{arch} bf16 train: the bf16 CSR "
            f"gather-sum launched {n16} times, want {want}")
    require(abs(l_dev - l_cpu) <= 1e-2 * abs(l_cpu),
            f"{arch} bf16 train: loss {l_dev} on the card, {l_cpu} on the CPU")
    worst = 0.0
    for k, want in g_cpu.items():
        tol = 8 * 2.0 ** -8 * float(want.abs().max())
        err = float((g_dev[k] - want).abs().max())
        require(err <= tol, f"{arch} bf16 train: grad {k} differs by {err} "
                f"(tol {tol})")
        worst = max(worst, err / max(tol, 1e-30))
    return {"loss_cpu": l_cpu, "loss_card": l_dev,
            "worst_grad_err_over_tol": worst}


def lm_not_run(arch: str, shape: str) -> dict:
    """The reckoning that keeps a train cell off one card: one layer's
    bf16 params and gradients (with the embedding and the head), before
    any optimizer state or activation, against ``PEAK_SHARE`` of the
    card; it must pass it. Beside it, the cell's argument bytes a rank
    on the (16, 16) mesh from the dry run (``launch.dryrun``: the port's
    own layouts, and the reference's)."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as T

    from repro_torch.launch import dryrun

    cfg = get_arch(arch).full_config()
    one = dataclasses.replace(cfg, n_layers=cfg.layers_per_block)
    need = T.count_params(one) * 2 * 2
    room = PEAK_SHARE * torch.cuda.get_device_properties(0).total_memory
    rank = dryrun.run_cell(arch, shape, verbose=False, args_only=True)
    require(rank["ok"] is True, f"{arch}:{shape}: the dry run failed: "
            f"{rank.get('error')}")
    res = {"cell": f"{arch}:{shape}", "run": False,
           "n_layers": one.n_layers, "params": T.count_params(one),
           "params_and_grads_gb": need / 1e9, "room_gb": room / 1e9,
           "why": "one layer's bf16 params and gradients alone pass "
                  f"{PEAK_SHARE:.0%} of the card",
           "rank_gb_16x16": rank["arg_bytes_per_device"] / 1e9,
           "reference_layout_gb_16x16":
               rank["reference_layout_bytes"] / 1e9,
           "fsdp_16x16": rank["fsdp"], "optimizer": rank["optimizer"]}
    require(need > room, f"{arch}:{shape} would fit one card: {res}")
    log(f"lm {arch}:{shape}: not run: {res}")
    return res


def lm_path() -> dict:
    """The LM family through its entry points at the published widths
    on the card (:func:`lm_cell` each, ``LM_CELLS``: the dense LMs,
    gemma's long_500k, the MoE LMs), the full-width train cells
    (:func:`lm_train_cell`: ``LM_TRAIN_CELLS``, ``LM_MOE_TRAIN_CELL``),
    the train cell one card cannot hold (:func:`lm_not_run`), then the
    smoke cells on the card against the CPU path. The token lookup's
    kernel must run once a request in every cell."""
    import torch

    t0 = time.perf_counter()
    res = {"cells": [lm_cell(a, s, n) for a, s, n in LM_CELLS]}
    res["serve_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    res["train"] = [lm_train_cell(a, s, n) for a, s, n in LM_TRAIN_CELLS]
    res["train_moe"] = lm_train_cell(*LM_MOE_TRAIN_CELL, every_step=False)
    res["train_s"] = time.perf_counter() - t1
    res["not_run"] = lm_not_run(*LM_NOT_RUN)
    total = {}
    for c in res["cells"] + res["train"] + [res["train_moe"]]:
        for k, v in c["launches"].items():
            total[k] = total.get(k, 0) + v
    res["launches"] = total
    t1 = time.perf_counter()
    res["small_reference"] = lm_small_reference()
    res["small_reference_s"] = time.perf_counter() - t1
    res["seconds"] = time.perf_counter() - t0
    log(f"lm phase: {res['seconds']:.1f} s, launches {total}")
    return res


# ---------------------------------------------------------------------------
# the LM cells over a mesh (an NCCL world of 1)
# ---------------------------------------------------------------------------
# the decode cells and their timed calls after one warm-up, and the train
# cell, each at its LM_ONE_CARD cut
LM_MESH_DECODE = (("gemma2-9b", "decode_32k", 5), ("dbrx-132b", "decode_32k", 5))
LM_MESH_TRAIN = ("dbrx-132b", "train_4k")
# GPipe: qwen1.5-32b at train_4k's sequence, 8 sequences in 8
# microbatches on one stage; bytes a param of the twin step (bf16 param
# and gradient, f32 accumulator, f32 AdamW moments) and the headroom
# left for activations and transients, against PEAK_SHARE of the card
LM_PP = ("qwen1.5-32b", "train_4k", 8, 8)
LM_PP_BYTES_PER_PARAM = 16
LM_PP_HEADROOM = 8e9
LM_PP_LR = 3e-4
# the collectives a call or step this phase printed on the NCCL world of
# 1 before a group of one rank stopped issuing any (the smoke of
# 5a52d90): no cell may issue more
LM_MESH_COLLECTIVES_CAP = {"gemma2-9b:decode_32k": 87,
                            "dbrx-132b:decode_32k": 19,
                            "dbrx-132b:train_4k": 526,
                            "qwen1.5-32b:train_4k gpipe": 37}
# kimi-k2's smoke config at this many experts: the reference's Adafactor
# route (128 or more), its experts over the model axis
LM_MESH_ADAFACTOR_EXPERTS = 128


def tensors_digest(tensors) -> str:
    """A digest of tensors' bits reckoned on the card (no copy to the
    host): each tensor's words, as int64, dotted with fixed weights in
    chunks (wrapping), then the sha256 of those sums."""
    import torch

    words = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    chunk = 1 << 24
    w = None
    sums = []
    for t in tensors:
        flat = t.detach().contiguous().view(-1).view(words[t.element_size()])
        if w is None:
            w = (torch.arange(1, chunk + 1, dtype=torch.int64,
                              device=flat.device) * 2654435761) % 2147483647
        acc = torch.zeros((), dtype=torch.int64, device=flat.device)
        for i in range(0, flat.numel(), chunk):
            part = flat[i:i + chunk].to(torch.int64)
            acc = acc * 1000003 + (part * w[:part.numel()]).sum()
        sums.append(acc)
    return digest(torch.stack(sums).cpu().numpy())


def written_slots(cache: dict, pos: int) -> dict:
    """The cache slots a decode step at ``pos`` writes (copies)."""
    out = {}
    for k, t in cache.items():
        length = t.shape[3]
        slot = pos % length if k.endswith("local") else min(pos, length - 1)
        out[k] = t[:, :, :, slot].clone()
    return out


def timed_calls(fn, args, n: int) -> tuple:
    """One warm-up and ``n`` timed calls: (last output, ms of each)."""
    from repro_torch.obs import clock

    out = fn(*args)
    ms = []
    for _ in range(n):
        sync("cuda")
        t = clock.now()
        out = fn(*args)
        sync("cuda")
        ms.append(clock.ms_between(t, clock.now()))
    return out, ms


def mesh_counts() -> dict:
    from repro_torch.distributed import parallel as par
    return dict(par.COUNTS)


def zero_mesh_counts() -> None:
    from repro_torch.distributed import parallel as par
    zero_counts()
    par.zero_counts()


def note(notes: str, key: str):
    """The value of ``key=...`` in a cell's comma-joined notes (None
    where it has none)."""
    for part in notes.split(","):
        if part.startswith(f"{key}="):
            return part[len(key) + 1:]
    return None


def data_axis_info(cell) -> dict:
    """A mesh cell's FSDP decision, accumulator dtype and count of params
    stored split over data axes, from its notes."""
    return {"fsdp": note(cell.notes, "fsdp") == "True",
            "accumulator": note(cell.notes, "accumulator"),
            "data_split_leaves": int(note(cell.notes, "data_split"))}


def require_collectives(label: str, n: float) -> None:
    want = LM_MESH_COLLECTIVES_CAP[label]
    require(n <= want, f"{label}: {n} collectives a call or step, more "
            f"than the {want} of the run before")


def lm_mesh_decode(mesh, arch: str, shape: str, n: int) -> dict:
    """A decode cell on the mesh beside its one-card twin, on the twin's
    params, cache and batch (on a world of 1 the mesh cell's blocks are
    those tensors): logits and written slots bitwise."""
    import gc

    import torch

    from repro_torch.launch.steps import LM_ONE_CARD, build_cell

    label = f"{arch}:{shape}"
    cut = LM_ONE_CARD[(arch, shape)]
    t0 = time.perf_counter()
    one = build_cell(arch, shape, smoke=False, device="cuda", **cut)
    sync("cuda")
    build_s = time.perf_counter() - t0
    pos = int(one.args[2]["pos"])
    out, one_ms = timed_calls(one.fn, one.args, n)
    want_logits = out[0].clone()
    want_slots = written_slots(out[1], pos)
    del out
    cell = build_cell(arch, shape, mesh=mesh, smoke=False, device="cuda",
                      args=one.args, **cut)
    require(cell.args[0]["embed"] is one.args[0]["embed"]
            and all(cell.args[1][k] is v for k, v in one.args[1].items()),
            f"{label}: the mesh cell does not hold the twin's tensors")
    zero_mesh_counts()
    out, mesh_ms = timed_calls(cell.fn, cell.args, n)
    sync("cuda")
    launches = {k: v for k, v in launch_counts().items() if v}
    launches_16 = counted_kernels()["embedding_bag"].launches_16
    coll = mesh_counts()
    cfg = lm_config(arch, shape)
    calls = n + 1
    require(torch.equal(out[0], want_logits),
            f"{label}: the mesh cell's logits are not the one-card cell's")
    got_slots = written_slots(out[1], pos)
    require(all(torch.equal(got_slots[k], v) for k, v in want_slots.items()),
            f"{label}: the cache slots the mesh step wrote differ")
    want_16 = calls * (cfg.n_layers if cfg.moe is not None else 0)
    require(launches.get("codebook_lookup") == calls,
            f"{label}: codebook_lookup launched {launches} in {calls} calls")
    require(launches_16 == want_16
            and launches.get("embedding_bag", 0) == want_16,
            f"{label}: the bf16 CSR gather-sum launched {launches_16} "
            f"({launches}), want {want_16}")
    require_collectives(label, coll["collectives"] / calls)
    res = {"cell": label, "reduced": list(cell.reduced), "notes": cell.notes,
           **data_axis_info(cell), "calls": calls, "build_s": build_s,
           "ms": mesh_ms, "ms_median": statistics.median(mesh_ms),
           "one_card_ms": one_ms,
           "one_card_ms_median": statistics.median(one_ms),
           "launches": launches, "launches_bf16_gather_sum": launches_16,
           "collectives_per_call": coll["collectives"] / calls,
           "all_reduce_bytes_per_call": coll["all_reduce_bytes"] / calls,
           "all_gather_bytes_per_call": coll["all_gather_bytes"] / calls,
           "logits_digest": digest(want_logits.cpu().numpy()),
           "slots_digest": tensors_digest(want_slots.values()),
           "bitwise": True}
    del one, cell, out, want_slots
    gc.collect()
    torch.cuda.empty_cache()
    log(f"lm_mesh {label}: {res}")
    return res


def lm_mesh_train(mesh, arch: str, shape: str) -> dict:
    """One train step of the cell on the mesh and of its one-card twin,
    each drawn afresh from seed 0: loss and every updated param
    bitwise."""
    import gc

    import torch

    from repro_torch.launch.steps import LM_ONE_CARD, build_cell
    from repro_torch.models.recsys import flat_params
    from repro_torch.obs import clock

    label = f"{arch}:{shape}"
    cut = LM_ONE_CARD[(arch, shape)]
    res = {"cell": label}
    for name, kw in (("one_card", {}), ("mesh", {"mesh": mesh})):
        torch.cuda.empty_cache()
        cell = build_cell(arch, shape, smoke=False, device="cuda", **kw,
                          **cut)
        sync("cuda")
        zero_mesh_counts()
        t = clock.now()
        loss = cell.fn(*cell.args)[2]
        sync("cuda")
        ms = clock.ms_between(t, clock.now())
        res[name] = {"step_ms": ms, "loss": float(loss),
                     "params_digest": tensors_digest(
                         flat_params(cell.args[0]).values()),
                     "launches": {k: v for k, v in launch_counts().items()
                                  if v},
                     "launches_bf16_gather_sum":
                         counted_kernels()["embedding_bag"].launches_16,
                     **{f"{k}_per_step": v for k, v in
                        mesh_counts().items()}}
        if name == "mesh":
            res["notes"] = cell.notes
            res["reduced"] = list(cell.reduced)
            res.update(data_axis_info(cell))
        del cell, loss
        gc.collect()
    one, m = res["one_card"], res["mesh"]
    require(m["loss"] == one["loss"]
            and m["params_digest"] == one["params_digest"],
            f"{label}: the mesh step's loss or params differ from the "
            f"one-card step's: {one} / {m}")
    require(m["launches"] == one["launches"]
            and m["launches_bf16_gather_sum"]
            == one["launches_bf16_gather_sum"],
            f"{label}: launches differ: {one['launches']} / {m['launches']}")
    require(m["launches"].get("codebook_lookup", 0) > 0
            and m["launches_bf16_gather_sum"] > 0,
            f"{label}: a kernel of the path did not run: {m['launches']}")
    require(res["fsdp"] and res["accumulator"] == "bfloat16"
            and res["data_split_leaves"] > 0,
            f"{label}: FSDP by the rule and a bf16 accumulator: {res}")
    require_collectives(label, m["collectives_per_step"])
    res["launches"] = m["launches"]
    res["launches_bf16_gather_sum"] = m["launches_bf16_gather_sum"]
    res["bitwise"] = True
    torch.cuda.empty_cache()
    log(f"lm_mesh train {label}: {res}")
    return res


def lm_pp_layers(arch: str) -> dict:
    """The pipeline check's depth: the most layers whose params, at
    ``LM_PP_BYTES_PER_PARAM`` bytes each, leave ``LM_PP_HEADROOM`` within
    ``PEAK_SHARE`` of the card (the twin step holds params, gradients,
    an f32 accumulator and two f32 moments)."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as T

    cfg = get_arch(arch).full_config()
    room = PEAK_SHARE * torch.cuda.get_device_properties(0).total_memory
    n = 0
    for layers in range(1, cfg.n_layers + 1):
        c = dataclasses.replace(cfg, n_layers=layers)
        if (T.count_params(c) * LM_PP_BYTES_PER_PARAM + LM_PP_HEADROOM
                > room):
            break
        n = layers
    require(n >= 1, f"{arch}: not one layer fits the pipeline check")
    c = dataclasses.replace(cfg, n_layers=n)
    return {"n_layers": n, "params": T.count_params(c),
            "bytes": T.count_params(c) * LM_PP_BYTES_PER_PARAM,
            "headroom": LM_PP_HEADROOM, "room": room}


def lm_mesh_pp(mesh) -> dict:
    """qwen1.5-32b's GPipe step on one stage against the microbatched
    one-card step at the same cut, same params (seed 0) and batch."""
    import gc

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.pipeline import build_pp_train_cell
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.recsys import flat_params
    from repro_torch.obs import clock

    arch, shape, batch, n_micro = LM_PP
    reckon = lm_pp_layers(arch)
    n_layers = reckon["n_layers"]
    full = get_arch(arch).full_config()
    seq = get_arch(arch).shape(shape).dims["seq_len"]
    label = f"{arch}:{shape} gpipe"
    res = {"cell": label, "reckoning": reckon,
           "reduced": [f"global_batch 256 -> {batch}",
                       f"n_layers {full.n_layers} -> {n_layers}"],
           "microbatches": n_micro, "stages": 1}
    torch.cuda.empty_cache()
    one = build_cell(arch, shape, smoke=False, device="cuda", batch=batch,
                     n_layers=n_layers)
    require(f"microbatches={n_micro}" in one.notes,
            f"{label}: the twin runs {one.notes}")
    sync("cuda")
    t = clock.now()
    want_loss = float(one.fn(*one.args)[2])
    sync("cuda")
    res["one_card_step_ms"] = clock.ms_between(t, clock.now())
    want = {k: v.cpu() for k, v in flat_params(one.args[0]).items()}
    del one
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(full, n_layers=n_layers)
    cell = build_pp_train_cell(cfg, global_batch=batch, seq=seq, mesh=mesh,
                               n_micro=n_micro, device="cuda")
    sync("cuda")
    torch.cuda.reset_peak_memory_stats()
    zero_mesh_counts()
    t = clock.now()
    loss = float(cell.fn(*cell.args)[2])
    sync("cuda")
    res["step_ms"] = clock.ms_between(t, clock.now())
    res["launches"] = {k: v for k, v in launch_counts().items() if v}
    res["launches_bf16_gather_sum"] = \
        counted_kernels()["embedding_bag"].launches_16
    res.update({f"{k}_per_step": v for k, v in mesh_counts().items()})
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["loss"], res["one_card_loss"] = loss, want_loss
    res["notes"] = cell.notes
    res["data_split_leaves"] = int(note(cell.notes, "data_split"))
    require_collectives(label, res["collectives_per_step"])
    n_diff = n_all = 0
    worst = 0.0
    for k, v in flat_params(cell.args[0]).items():
        w = want[k].to(v.device).float()
        d = (v.float() - w).abs()
        n_diff += int((d > 0).sum())
        n_all += d.numel()
        worst = max(worst, float((d - 2 * LM_PP_LR
                                  - w.abs() * 2.0 ** -7).max()))
    res["params_differing"] = n_diff / n_all
    res["worst_over_bound"] = worst
    res["tolerance"] = ("loss rtol 1e-5; at most 1% of params differ, each "
                        "by at most 2 lr + 2^-7 |p|")
    del cell, want
    gc.collect()
    torch.cuda.empty_cache()
    require(abs(loss - want_loss) <= 1e-5 * abs(want_loss),
            f"{label}: loss {loss} vs the microbatched step's {want_loss}")
    require(res["params_differing"] <= 0.01 and worst <= 0,
            f"{label}: params differ beyond the bound: {res}")
    require(res["launches"].get("codebook_lookup") == n_micro
            and res["launches_bf16_gather_sum"] == n_micro
            and res["launches"].get("embedding_bag") == n_micro,
            f"{label}: the lookup and its bf16 backward must launch once a "
            f"microbatch: {res['launches']}")
    log(f"lm_mesh {label}: {res}")
    return res


def lm_mesh_adafactor(mesh, device: str = "cuda") -> dict:
    """One train step of kimi-k2's smoke config at
    ``LM_MESH_ADAFACTOR_EXPERTS`` experts (the reference's Adafactor
    route) on the mesh and as its one-card twin, each drawn from seed 0
    on the card with the CUDA lookup: loss and every updated param
    bitwise, equal launches, codebook_lookup and the CSR gather-sum
    run."""
    import gc

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.steps import _lm_cell
    from repro_torch.models.recsys import flat_params
    from repro_torch.models.transformer import MoEConfig

    spec = get_arch("kimi-k2-1t-a32b")
    cfg = dataclasses.replace(spec.smoke_config(), moe=MoEConfig(
        LM_MESH_ADAFACTOR_EXPERTS, 2, 1.5))
    spec = dataclasses.replace(spec, smoke_config=lambda: cfg)
    label = f"kimi-k2 smoke {LM_MESH_ADAFACTOR_EXPERTS} experts:train_4k"
    res = {"cell": label}
    for name, kw in (("one_card", {}), ("mesh", {"mesh": mesh})):
        cell = _lm_cell(spec, spec.shape("train_4k"), True, "cuda",
                        torch.device(device), **kw)
        sync(device)
        zero_mesh_counts()
        loss = cell.fn(*cell.args)[2]
        sync(device)
        res[name] = {"loss": float(loss), "notes": cell.notes,
                     "params_digest": tensors_digest(
                         flat_params(cell.args[0]).values()),
                     "launches": {k: v for k, v in launch_counts().items()
                                  if v},
                     **{f"{k}_per_step": v for k, v in
                        mesh_counts().items()}}
        del cell, loss
        gc.collect()
    one, m = res["one_card"], res["mesh"]
    require(m["notes"].startswith("optimizer=adafactor,"),
            f"{label}: not the Adafactor route: {m['notes']}")
    require(m["loss"] == one["loss"]
            and m["params_digest"] == one["params_digest"],
            f"{label}: the mesh step differs from its twin: {res}")
    require(m["launches"] == one["launches"]
            and m["launches"].get("codebook_lookup", 0) > 0
            and m["launches"].get("embedding_bag", 0) > 0,
            f"{label}: launches {one['launches']} / {m['launches']}")
    res["launches"] = m["launches"]
    res["launches_bf16_gather_sum"] = 0
    res["bitwise"] = True
    log(f"lm_mesh {label}: {res}")
    return res


def lm_mesh_path() -> dict:
    """The LM cells over an NCCL world of 1 (module docstring)."""
    import torch.distributed as dist

    from repro_torch.distributed import world
    from repro_torch.launch.mesh import make_host_mesh

    require(not dist.is_initialized(),
            "a process group is alive before the lm_mesh phase")
    t0 = time.perf_counter()
    with world("cuda"):
        mesh = make_host_mesh("cuda")
        res = {"decode": [lm_mesh_decode(mesh, *c) for c in LM_MESH_DECODE],
               "train": lm_mesh_train(mesh, *LM_MESH_TRAIN),
               "gpipe": lm_mesh_pp(mesh),
               "adafactor": lm_mesh_adafactor(mesh)}
    require(not dist.is_initialized(), "the NCCL world outlived its phase")
    total = {}
    cells = res["decode"] + [res["train"], res["gpipe"], res["adafactor"]]
    for c in cells:
        for k, v in c["launches"].items():
            total[k] = total.get(k, 0) + v
    res["launches"] = total
    res["launches_bf16_gather_sum"] = sum(c["launches_bf16_gather_sum"]
                                          for c in cells)
    res["seconds"] = time.perf_counter() - t0
    log(f"lm_mesh phase: {res['seconds']:.1f} s, launches {total}")
    return res


# ---------------------------------------------------------------------------
# the dry run: every cell's per-rank account on the production meshes
# ---------------------------------------------------------------------------
def dryrun_path() -> dict:
    """``launch.dryrun`` over every cell (``--all --both-meshes
    --include-variants --args-only``: the arguments' bytes; the compiled
    half runs on the CPU, ``op_analysis_path`` holds it against the card),
    in this process on meta tensors: it must record no failure and touch
    no device. Returns the counts and the
    GB a rank of every LM cell (the port's layouts and the
    reference's)."""
    import torch

    from repro_torch.configs import all_cells
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    results = dryrun.run(all_cells(include_skipped=True,
                                   include_variants=True), [False, True],
                         verbose=False, args_only=True)
    n_ok, n_skip, n_fail = dryrun.summary(results)
    require(n_fail == 0, "the dry run failed: " + "; ".join(
        f"{r['arch']}:{r['shape']} {r['mesh']}: {r.get('error')}"
        for r in results if r["ok"] is False))
    require(torch.cuda.memory_allocated() == before,
            "the dry run allocated on the card")
    lm = {f"{r['mesh']} {r['arch']}:{r['shape']}": {
        "gb": r["arg_bytes_per_device"] / 1e9,
        "reference_layout_gb": r["reference_layout_bytes"] / 1e9,
        "builds": r["builds"], "fits": r["fits"]}
        for r in results if r["ok"] is True
        and r["arch"] in LM_ARCHS}
    res = {"ok": n_ok, "skipped": n_skip, "failed": n_fail,
           "lm_gb_per_rank": lm,
           "not_fitting": [f"{r['mesh']} {r['arch']}:{r['shape']}"
                           for r in results if r.get("fits") is False],
           "seconds": time.perf_counter() - t0}
    log(f"dryrun: {n_ok} ok / {n_skip} skipped / {n_fail} failed in "
        f"{res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# one-card steps counted by launch.op_analysis against their reckoning
# ---------------------------------------------------------------------------
# (arch, shape, timed calls): steps other phases build, each at its
# LM_ONE_CARD cut (dbrx-132b's train_4k at 1 layer, gemma2-9b's decode_32k
# at B 4) or at full width (lightgcn-baco's bpr_train at amazonbook's
# width, B 1,024; DLRM-BACO's serve_p99, B 512)
OP_STEPS = (("lightgcn-baco", "bpr_train", 10),
            ("dlrm-mlperf-baco", "serve_p99", 10),
            ("dbrx-132b", "train_4k", 2),
            ("gemma2-9b", "decode_32k", 5))
# the counted step's peak temporaries against the caching allocator's
# peak over it (from a reset, less what was allocated before): the
# allocator rounds every block up to 512 bytes, and cuBLAS's workspace
# and a kernel wrapper's own scratch are not counted. On an H100 the
# allocator's peak lay 2,552 / 0 / 2,028 / 182,776 bytes above the
# reckoning for the four steps in order, so 1 MiB and a thousandth
OP_TEMP_RTOL = 1e-3
OP_TEMP_ATOL = 1 << 20
OP_EXACT = ("hbm_bytes", "kernels", "host_reads")


def op_step(arch: str, shape: str, n: int) -> dict:
    """One step of a cell on the card, once more after a warm-up under
    ``launch.op_analysis.OpAnalysis``, then ``n`` timed calls (CUDA
    events around each, median), and its reckoning on meta tensors
    (``launch.dryrun.reckon``: the same cut, no world). The counts must
    equal: dot FLOPs by dtype, HBM bytes, kernel calls by name, host
    reads; the peak temporaries the reckoning gives must lie within
    ``OP_TEMP_RTOL`` / ``OP_TEMP_ATOL`` of the allocator's peak over the
    counted step. The three roofline terms (``launch.roofline.terms_s``,
    the H100's published peaks) beside the measured ms, and
    ``bound_frac_of_measured`` = the largest term / the measured ms (not
    ``launch.roofline``'s ``roofline_frac``, the compute term's share of
    the largest)."""
    import gc

    import torch

    from repro_torch.launch import dryrun, op_analysis, roofline, steps

    label = f"{arch}:{shape}"
    cuts = steps.LM_ONE_CARD.get((arch, shape), {})
    gc.collect()
    torch.cuda.empty_cache()
    cell = steps.build_cell(arch, shape, device="cuda", **cuts)
    out = cell.fn(*cell.args)                  # warm-up
    del out
    sync("cuda")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    oa = op_analysis.OpAnalysis().arguments(cell.args)
    with oa:
        out = cell.fn(*cell.args)
    sync("cuda")
    alloc_peak = torch.cuda.max_memory_allocated() - base
    oa.finish(out)
    del out
    got, got_mem = oa.metrics(), oa.memory()
    ms = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = cell.fn(*cell.args)
        b.record()
        del out
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    ms = sorted(ms)[len(ms) // 2]
    del cell
    gc.collect()
    torch.cuda.empty_cache()
    want, want_mem = dryrun.reckon(arch, shape, **cuts)
    dots = {k: v for k, v in got.items() if k.startswith("dot_flops")}
    require(dots == {k: v for k, v in want.items()
                     if k.startswith("dot_flops")},
            f"op analysis {label}: the card's dot FLOPs {dots} differ from "
            f"the reckoning's")
    for key in OP_EXACT:
        require(got[key] == want[key],
                f"op analysis {label}: {key} on the card {got[key]} differs "
                f"from the reckoning's {want[key]}")
    temp = want_mem["temp_size_in_bytes"]
    for what, v in (("the allocator's peak", alloc_peak),
                    ("the counted peak", got_mem["temp_size_in_bytes"])):
        require(abs(v - temp) <= OP_TEMP_RTOL * temp + OP_TEMP_ATOL,
                f"op analysis {label}: {what} {v} bytes is not within "
                f"{OP_TEMP_RTOL} + {OP_TEMP_ATOL} bytes of the reckoned "
                f"temporaries {temp}")
    t = roofline.terms_s(got)
    row = {"step": label, "cuts": cuts, "ms": ms,
           "compute_ms": t["compute_s"] * 1e3,
           "memory_ms": t["memory_s"] * 1e3,
           "collective_ms": t["collective_s"] * 1e3,
           "bottleneck": t["bottleneck"],
           "bound_frac_of_measured": t["bound_s"] * 1e3 / ms,
           "dot_flops": dots, "hbm_bytes": got["hbm_bytes"],
           "kernels": got["kernels"], "host_reads": got["host_reads"],
           "branches": want.get("branches", []),
           "temp_bytes": {"reckoned": temp,
                          "counted": got_mem["temp_size_in_bytes"],
                          "allocator": alloc_peak},
           "argument_bytes": want_mem["argument_size_in_bytes"]}
    log(f"op analysis {label}: {ms:.3f} ms; compute {row['compute_ms']:.3f} "
        f"/ memory {row['memory_ms']:.3f} / collective "
        f"{row['collective_ms']:.3f} ms ({t['bottleneck']}), "
        f"bound_frac_of_measured {row['bound_frac_of_measured']:.4f}; "
        f"counts equal the reckoning")
    return row


def op_analysis_path() -> dict:
    """Each of ``OP_STEPS`` through :func:`op_step`, with no
    ``torch.distributed`` world open (the reckoning opens none either)."""
    import torch.distributed as dist

    require(not dist.is_initialized(),
            "a torch.distributed world is still open before the op analysis")
    t0 = time.perf_counter()
    rows = [op_step(*c) for c in OP_STEPS]
    return {"gpu": gpu_line(), "steps": rows,
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# the recsys, cf and GNN cells over a mesh (an NCCL world of 1)
# ---------------------------------------------------------------------------
# (arch, shape, timed calls or steps after the first): each at full
# published width (SchNet's at its GNN_ONE_CARD cut) beside its twin
ARCH_MESH_CELLS = (("dlrm-mlperf-baco", "serve_p99", 10),
                   ("wide-deep-baco", "train_batch", 3),
                   ("sasrec-baco", "train_batch", 3),
                   ("lightgcn-baco", "bpr_train", 5),
                   ("schnet", "minibatch_lg", 3))
# the cells no single H100 holds, reckoned by launch.steps.rank_bytes on
# one card and on these (data, model) meshes
ARCH_NOT_RUN = (("dlrm-mlperf", "serve_p99"), ("dlrm-mlperf", "train_batch"),
                ("dlrm-mlperf-baco", "train_batch"),
                ("bert4rec-baco", "train_batch"))
ARCH_RECKON_MESHES = ((4, 1), (8, 1))
# (arch, shape): the tables whose block lookup is held apart, each the
# largest of its kind in the cell's full config
ARCH_BLOCK_CHECKS = {("dlrm-mlperf-baco", "serve_p99"): ("emb_0",),
                     ("wide-deep-baco", "train_batch"): ("emb_39",
                                                         "wide_39")}


def all_launches() -> dict:
    """Every launch counter by name: each kernel's, and flash_attention's
    by route and the CSR gather-sum's weighted and 16-bit launches."""
    fns = counted_kernels()
    fa, eb = fns["flash_attention"], fns["embedding_bag"]
    return {**launch_counts(), "flash_attention_tc": fa.launches_tc,
            "flash_attention_cc": fa.launches_cc,
            "embedding_bag_weighted": eb.launches_weighted,
            "embedding_bag_16": eb.launches_16}


def arch_block_lookup(table, b: int, label: str, seed: int = 0) -> dict:
    """A row block's lookup (``EmbeddingEngine.block_lookup``: the
    codebook_lookup kernel, backward the CSR gather-sum) on a block that
    starts past row 0: the middle half of ``table`` [n, d], rows
    [n/4, n/4 + n/2), for ``b`` seeded ids over all n rows, so about half
    fall outside the block. The rows and the block's gradient of a
    seeded cotangent must equal the plain version's (the "gather"
    backend's ``block`` on the same inputs) bitwise: the cotangent holds
    small integers, which sum exactly in any order, so the plain
    version's atomic adds give the same floats. Each kernel must launch
    once (these launches are a check's and count into no path)."""
    import torch

    from repro_torch.embedding import EmbeddingEngine, EmbeddingSpec
    from repro_torch.embedding import get_backend

    n, d = table.shape
    lo, m = n // 4, n // 2
    gen = torch.Generator(device=table.device).manual_seed(seed)
    ids = torch.randint(0, n, (b,), device=table.device, generator=gen)
    cot = torch.randint(-8, 9, (b, d), device=table.device,
                        generator=gen).to(table.dtype)
    inside = int(((ids >= lo) & (ids < lo + m)).sum())
    require(0 < inside < b, f"{label}: the ids do not straddle the block")
    spec = EmbeddingSpec(n_rows=m, dim=d)

    def run(lookup):
        blk = table[lo:lo + m].detach().requires_grad_(True)
        rows = lookup(blk)
        (grad,) = torch.autograd.grad(rows, blk, cot)
        return rows.detach(), grad

    zero_counts()
    got, got_g = run(lambda t: EmbeddingEngine(spec).block_lookup(t, ids, lo))
    sync("cuda")
    launches = {k: v for k, v in launch_counts().items() if v}
    want, want_g = run(lambda t: get_backend("gather").block(t, ids, lo))
    res = {"table": label, "rows": m, "lo": lo, "d": d, "ids": b,
           "ids_inside": inside, "launches": launches,
           "rows_bitwise": bool(torch.equal(got, want)),
           "grad_bitwise": bool(torch.equal(got_g, want_g)),
           "foreign_rows_zero": bool(torch.equal(
               got[(ids < lo) | (ids >= lo + m)],
               torch.zeros((b - inside, d), dtype=got.dtype,
                           device=got.device)))}
    require(res["rows_bitwise"] and res["grad_bitwise"]
            and res["foreign_rows_zero"],
            f"{label}: the block lookup disagrees with its plain version: "
            f"{res}")
    require(launches == {"codebook_lookup": 1, "embedding_bag": 1},
            f"{label}: the block lookup launched {launches}")
    del got, got_g, want, want_g
    return res


def arch_mesh_cell(mesh, arch: str, shape: str, n: int,
                   device: str = "cuda", smoke: bool = False) -> dict:
    """One cell through ``build_cell(mesh=...)`` beside its one-card twin,
    built from the twin's args (a train cell's params cloned, so each
    steps its own copy from the same values, with a fresh optimizer
    state each): the first call's outputs (a train step's loss and every
    updated param) bitwise the twin's, and its launches equal; then
    ``n`` timed calls of each. Peak memory from a reset at the cell's
    start must stay under ``PEAK_SHARE`` of the card."""
    import gc

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.steps import GNN_ONE_CARD, build_cell
    from repro_torch.models.recsys import flat_params

    label = f"{arch}:{shape}"
    cut = {} if smoke else GNN_ONE_CARD.get((arch, shape), {})
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    one = build_cell(arch, shape, smoke=smoke, device=device, **cut)
    train = one.kind == "train"
    args = one.args
    if train:
        args = (_to(one.args[0], device), None) + tuple(one.args[2:])
    cell = build_cell(arch, shape, mesh=mesh, smoke=smoke, device=device,
                      args=args, **cut)
    sync(device)
    build_s = time.perf_counter() - t0
    mine = flat_params(args[0])
    require(all(v is mine[k] for k, v in flat_params(cell.args[0]).items()),
            f"{label}: the mesh cell does not hold its args' tensors")
    zero_counts()
    want = one.fn(*one.args)
    sync(device)
    one_launches = all_launches()
    zero_mesh_counts()
    got = cell.fn(*cell.args)
    sync(device)
    launches = all_launches()
    coll = mesh_counts()
    if train:
        want_p = flat_params(want[0])
        same = (torch.equal(got[2], want[2])
                and all(torch.equal(v, want_p[k])
                        for k, v in flat_params(got[0]).items()))
        out = {"loss": float(got[2])}
    else:
        same = torch.equal(got, want)
        out = {"out_shape": list(got.shape),
               "out_digest": tensors_digest([got])}
    require(same, f"{label}: the mesh cell's first "
            f"{'step' if train else 'call'} is not bitwise its twin's")
    require(launches == one_launches, f"{label}: launches differ: twin "
            f"{one_launches}, mesh {launches}")
    del want, got
    _, one_ms = timed_calls(one.fn, one.args, n)
    zero_counts()
    _, ms = timed_calls(cell.fn, cell.args, n)
    sync(device)
    timed = all_launches()
    res = {"cell": label, "kind": cell.kind, "notes": cell.notes,
           "reduced": list(cell.reduced), "build_s": build_s, **out,
           "calls": n + 2, "bitwise": True,
           "launches_per_call": {k: v for k, v in launches.items() if v},
           "launches": {k: launches[k] + timed[k] for k in launches
                        if launches[k] + timed[k]},
           "collectives_per_call": coll["collectives"],
           "all_reduce_bytes_per_call": coll["all_reduce_bytes"],
           "all_gather_bytes_per_call": coll["all_gather_bytes"],
           "ms": ms, "ms_median": statistics.median(ms),
           "one_card_ms": one_ms,
           "one_card_ms_median": statistics.median(one_ms)}
    checks = ARCH_BLOCK_CHECKS.get((arch, shape), ())
    if device == "cuda" and checks:
        b = get_arch(arch).shape(shape).dims["batch"]
        mine = flat_params(args[0])
        res["block_checks"] = [
            arch_block_lookup(mine[k], b, f"{label} {k}", seed=i)
            for i, k in enumerate(checks)]
    if device == "cuda":
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        require_peak(label, res["peak_gb"] * 1e9)
    del one, cell, args, mine
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    log(f"arch_mesh {label}: {res}")
    return res


def arch_not_run() -> list:
    """The recsys cells no single card holds, reckoned by
    ``launch.steps.rank_bytes`` (params, gradients and AdamW moments a
    rank) on one card and on ``ARCH_RECKON_MESHES``; bert4rec-baco's
    train cell by its logits: three [B, n_mask, n_neg + 1] f32 tensors
    live at once (the negatives' einsum, the concatenation,
    logsumexp's exp), a data rank holding its batch rows. On one card
    each must pass ``PEAK_SHARE`` of it."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.steps import rank_bytes

    room = PEAK_SHARE * torch.cuda.get_device_properties(0).total_memory
    out = []
    for arch, shape in ARCH_NOT_RUN:
        cfg = get_arch(arch).full_config()
        b = get_arch(arch).shape(shape).dims["batch"]
        res = {"cell": f"{arch}:{shape}", "run": False,
               "room_gb": room / 1e9}
        for m in ((1, 1),) + ARCH_RECKON_MESHES:
            tag = "one_card" if m == (1, 1) else f"{m[0]}x{m[1]}"
            rb = rank_bytes(arch, shape, AbstractMesh(m, ("data", "model")))
            res[tag] = {k: v / 1e9 for k, v in rb.items()}
            if arch.startswith("bert4rec"):
                logits = 3 * (b // m[0]) * cfg.n_mask * (cfg.n_neg + 1) * 4
                res[tag]["logits_gb"] = logits / 1e9
        need = res["one_card"]["total"] + res["one_card"].get("logits_gb", 0)
        require(need * 1e9 > room, f"{arch}:{shape} would fit one card: "
                f"{res}")
        log(f"arch {arch}:{shape}: not run: {res}")
        out.append(res)
    return out


def arch_mesh_path() -> dict:
    """The recsys, cf and GNN cells over an NCCL world of 1 (module
    docstring), and the reckoning of the cells no single card holds."""
    import torch.distributed as dist

    from repro_torch.distributed import world
    from repro_torch.launch.mesh import make_host_mesh

    require(not dist.is_initialized(),
            "a process group is alive before the arch_mesh phase")
    t0 = time.perf_counter()
    with world("cuda"):
        mesh = make_host_mesh("cuda")
        res = {"cells": [arch_mesh_cell(mesh, *c) for c in ARCH_MESH_CELLS]}
    require(not dist.is_initialized(), "the NCCL world outlived its phase")
    total = {}
    for c in res["cells"]:
        for k, v in c["launches"].items():
            total[k] = total.get(k, 0) + v
    for k in ("codebook_lookup", "embedding_bag", "dot_interaction",
              "flash_attention"):
        require(total.get(k, 0) > 0, f"arch_mesh: {k} never ran")
    res["launches"] = total
    res["not_run"] = arch_not_run()
    res["seconds"] = time.perf_counter() - t0
    log(f"arch_mesh phase: {res['seconds']:.1f} s, launches {total}")
    return res


# ---------------------------------------------------------------------------
# the GNN family (SchNet) at full published width
# ---------------------------------------------------------------------------
# SchNet's four train cells, each at its one-card cut
# (launch.steps.GNN_ONE_CARD), with the timed steps after one warm-up
GNN_CELLS = (("full_graph_sm", 3), ("minibatch_lg", 3), ("molecule", 3),
             ("ogb_products", 3))


def gnn_cell(shape: str, n: int) -> dict:
    """One SchNet train cell at the published widths (d_hidden 64, 300
    RBF, 3 blocks, cutoff 10) through ``build_cell``: one warm-up step
    and ``n`` timed AdamW steps on a fixed batch. Counts zeroed just
    before the warm-up and read just after the last step: the CSR
    gather-sum runs twice a block (the receivers' segment sum, the
    gather's gradient), and in ``molecule`` once more for the per-graph
    energies and once for the atom embedding's gradient, after
    codebook_lookup's lookup. The warm-up's first segment sum and first
    gather gradient (and in ``molecule`` the atom lookup and its
    gradient) are recorded (:func:`first_calls`), then held bitwise
    against the plain version and timed beside it, their bound and
    ``index_add_`` (:func:`held_rows`). Losses finite; step ms, peak GB
    from a reset after the warm-up (15% of the card left free), the cut,
    and one more step under ``torch.profiler`` (device ms by kernel)."""
    import gc

    import torch

    from repro_torch.launch.steps import GNN_ONE_CARD, build_cell
    from repro_torch.obs import clock

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    label = f"schnet:{shape}"
    t0 = time.perf_counter()
    cell = build_cell("schnet", shape, smoke=False, device="cuda",
                      **GNN_ONE_CARD.get(("schnet", shape), {}))
    sync("cuda")
    build_s = time.perf_counter() - t0
    calls = {}
    zero_counts()
    with first_calls(recorded_calls(calls)):
        losses = [float(cell.fn(*cell.args)[2])]
    peak_warm = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(n):
        sync("cuda")
        t = clock.now()
        losses.append(float(cell.fn(*cell.args)[2]))
        step_ms.append(clock.ms_between(t, clock.now()))
    launches = {k: v for k, v in launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated()
    b = cell.args[2]
    molecule = shape == "molecule"
    blocks = len(cell.args[0]["blocks"])
    per_step = 2 * blocks + (2 if molecule else 0)
    res = {"cell": label, "reduced": list(cell.reduced), "notes": cell.notes,
           "nodes": int(b["z" if molecule else "feat"].shape[0]),
           "edges": int(b["edge_src"].shape[0]), "steps": n + 1,
           "build_s": build_s, "step_ms": step_ms,
           "step_ms_median": statistics.median(step_ms),
           "losses": losses, "launches": launches,
           "peak_gb": peak / 1e9, "peak_warmup_gb": peak_warm / 1e9}
    require(all(map(math.isfinite, losses)),
            f"{label}: a loss is not finite: {losses}")
    require(launches.get("embedding_bag") == per_step * (n + 1),
            f"{label}: the CSR gather-sum launched {launches} times, want "
            f"{per_step} a step")
    require(launches.get("codebook_lookup", 0) == (n + 1 if molecule else 0),
            f"{label}: codebook_lookup launched {launches}, want one a step "
            f"in molecule only")
    require_peak(label, max(peak, peak_warm))
    want = {"embedding_bag:segment_sum", "embedding_bag:gather_grad"} | (
        {"codebook_lookup", "embedding_bag"} if molecule else set())
    require(set(calls) == want, f"{label}: recorded {sorted(calls)}, want "
            f"{sorted(want)}")
    res["kernels"] = held_rows(calls)
    res["profile"] = profile_step(cell, label)
    del cell, b, calls
    gc.collect()
    torch.cuda.empty_cache()
    log(f"gnn {label}: {res}")
    return res


def profile_step(cell, label: str) -> dict:
    """One more step of a train cell under ``torch.profiler`` (after its
    launch counts were read): device time by kernel, wall time, idle
    share."""
    from torch.profiler import ProfilerActivity, profile

    sync("cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cell.fn(*cell.args)
        sync("cuda")
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = device_times(prof, 1)
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    log(f"profile ({label}, one step): device busy {busy:.3f} ms of "
        f"{wall_ms:.3f} ms")
    for name, ms in top:
        log(f"  {ms:9.4f} ms  {100 * ms / max(busy, 1e-9):5.1f}%  {name}")
    return {"device_ms": busy, "wall_ms": wall_ms,
            "idle_share": 1.0 - busy / wall_ms, "top_kernels_ms": dict(top)}


def gnn_small_reference(device: str = "cuda") -> dict:
    """Each SchNet smoke cell on the card against the port's CPU path on
    the same params and batch: the loss, and every param's gradient,
    within rtol 1e-4 / atol 1e-5 (f32 GEMMs sum in another order; the
    segment sums add in one order on both)."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import schnet as S

    out = {}
    for shape, _ in GNN_CELLS:
        cpu = build_cell("schnet", shape, smoke=True, device="cpu")
        molecule = shape == "molecule"
        cfg = dataclasses.replace(get_arch("schnet").smoke_config(),
                                  d_feat=0 if molecule else 16)
        loss_fn = S.train_loss if molecule else S.node_train_loss
        got = {}
        for dev in ("cpu", device):
            p = _to(cpu.args[0], dev)
            flat = S.flat_params(p)
            leaves = [t.requires_grad_(True) for t in flat.values()]
            loss = loss_fn(p, _to(cpu.args[2], dev), cfg)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            got[dev] = [loss.detach()] + [
                torch.zeros(t.shape) if x is None else x.detach()
                for t, x in zip(leaves, grads)]
        err = 0.0
        for a, b in zip(got[device], got["cpu"]):
            a = a.cpu()
            require(torch.allclose(a, b, rtol=1e-4, atol=1e-5),
                    f"schnet:{shape} smoke: the card differs from the CPU "
                    f"path")
            err = max(err, float((a - b).abs().max()))
        out[shape] = err
    log(f"gnn smoke cells, card == CPU path (max |err|): {out}")
    return out


def gnn_path() -> dict:
    """SchNet through its entry points at the published widths on the
    card (:func:`gnn_cell` each, ``GNN_CELLS``), then its smoke cells on
    the card against the CPU path."""
    t0 = time.perf_counter()
    res = {"cells": [gnn_cell(s, n) for s, n in GNN_CELLS]}
    total = {}
    for c in res["cells"]:
        for k, v in c["launches"].items():
            total[k] = total.get(k, 0) + v
    res["launches"] = total
    res["small_reference"] = gnn_small_reference()
    res["seconds"] = time.perf_counter() - t0
    log(f"gnn phase: {res['seconds']:.1f} s, launches {total}")
    return res


# ---------------------------------------------------------------------------
# phase 3: the embedding layer's entry points
# ---------------------------------------------------------------------------
def embedding_inputs(run: dict, device: str) -> dict:
    """The main path's trained codebooks, sketch and training bags as
    tensors on ``device``, int8 codebooks beside them."""
    import torch

    from repro_torch.embedding import quantize_int8_rows

    train, sketch = run["train"], run["sketch"]
    params = run["loaded"].params

    def t(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    out = {}
    for side, table, idx in (("items", "item_table", sketch.item_idx),
                             ("users", "user_table", sketch.user_idx)):
        q, scale = quantize_int8_rows(params[table])
        out[side] = {"z": t(params[table]), "sketch": t(idx, torch.int32),
                     "q": t(q), "scale": t(scale)}
    out["values"] = t(train.edge_v, torch.int32)        # user-sorted edges
    out["segments"] = t(train.edge_u, torch.int64)
    out["n_users"], out["n_items"] = train.n_users, train.n_items
    return out


def readout_cases(emb: dict, side: str, b: int, device: str):
    """(u, kwargs) cases of the codebook readout of ``side`` for the
    first ``b`` users: f32 and int8, bare, with a mask (-inf on every
    97th item) and with exclusions (each user's training items; on the
    users side, the user itself)."""
    import torch

    from repro_torch.embedding import EmbeddingEngine, EmbeddingSpec

    us = emb["users"]
    n_users = emb["n_users"]
    u0 = EmbeddingEngine(EmbeddingSpec(n_users, 64, k_rows=us["z"].shape[0],
                                       n_hot=2)).codebook_lookup(
        us["z"], us["sketch"], torch.arange(b, device=device))
    tab = emb[side]
    n = int(tab["sketch"].shape[0])
    mask = torch.zeros(n, device=device)
    mask[::97] = float("-inf")
    if side == "items":
        sel = emb["segments"] < b
        excl = (emb["segments"][sel], emb["values"][sel])
    else:
        excl = (torch.arange(b, device=device),
                torch.arange(b, device=device))
    for quant in (False, True):
        base = ({"items": tab["q"], "scale": tab["scale"]} if quant
                else {"items": tab["z"]})
        for extra in ({}, {"mask": mask}, {"exclude": excl}):
            yield u0, {**base, "sketch": tab["sketch"], **extra}


def embedding_path(run: dict, device: str = "cuda") -> dict:
    """Drives ``repro_torch.embedding`` at full width (``device="cpu"``
    on a small dataset rehearses the same code without a GPU)."""
    import numpy as np
    import torch

    from repro_torch.embedding import (EmbeddingEngine, EmbeddingSpec,
                                       embedding_bag, fused_topk)
    from repro_torch.kernels import ref
    from repro_torch.models import lightgcn as L

    emb = embedding_inputs(run, device)
    k = 20
    t0 = time.perf_counter()
    zero_counts()
    # the codebook readout, against the plain version
    n_cases, n_diff = 0, 0
    for side in ("items", "users"):
        for b in (1, 8, 64, 512):
            for u, kw in readout_cases(emb, side, b, device):
                items = kw.pop("items")
                got_v, got_i = fused_topk(u, items, k, **kw)
                want_v, want_i = ref.fused_topk(u, items, k, **kw)
                sync(device)
                exp = ref.expand_items(items, kw.get("scale"), kw["sketch"])
                n_diff += topk_agree(got_v.cpu(), got_i.cpu(), want_v.cpu(),
                                     want_i.cpu(),
                                     pair_scorer(u, exp, mask=kw.get("mask")))
                n_cases += 1
    log(f"codebook readout: {n_cases} cases (items N={emb['n_items']} H=1, "
        f"users N={emb['n_users']} H=2; B 1..512; f32/int8; mask; "
        f"exclusions) agree with the plain version ({n_diff} ids differ "
        f"at near-ties)")
    # exact on integer-valued codebooks, at the same shapes
    g = torch.Generator(device="cpu").manual_seed(2)
    for side in ("items", "users"):
        tab = emb[side]
        zi = torch.randint(-2, 3, tuple(tab["z"].shape), generator=g)
        zi = zi.float().to(device)
        ui = torch.randint(-2, 3, (512, 64), generator=g).float().to(device)
        got = fused_topk(ui, zi, k, sketch=tab["sketch"])
        want = ref.fused_topk(ui, zi, k, sketch=tab["sketch"])
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                f"codebook readout ({side}) not exact on integer inputs")
    log("codebook readout on integer-valued codebooks: exact (items, users)")

    # every user's bag of training items, over the expanded item table
    items = emb["items"]
    v0 = EmbeddingEngine(EmbeddingSpec(emb["n_items"], 64,
                                       k_rows=items["z"].shape[0])) \
        .codebook_lookup(items["z"], items["sketch"])
    vals, segs, n_users = emb["values"], emb["segments"], emb["n_users"]
    plain_sum = ref.embedding_bag(v0, vals, segs, n_users)
    cnt = torch.bincount(segs, minlength=n_users).clamp(min=1).float()
    for mode, want in (("sum", plain_sum),
                       ("mean", plain_sum / cnt[:, None])):
        got = embedding_bag(v0, vals, segs, n_users, mode=mode)
        require(torch.equal(got, want),
                f"bag lookup ({mode}) is not bitwise the plain version")
    # empty and single-value bags; the same bags with their values in a
    # random order (unsorted segment ids, no declaration)
    keep = (segs % 3 != 1) & (segs < 5000)
    first = torch.ones_like(keep)
    first[1:] = segs[1:] != segs[:-1]
    shuffled = torch.randperm(vals.numel(), generator=g).to(device)
    for name, sel in (("empty bags", keep), ("single values", first),
                      ("unsorted", shuffled)):
        got = embedding_bag(v0, vals[sel], segs[sel], n_users)
        want = ref.embedding_bag(v0, vals[sel], segs[sel], n_users)
        require(torch.equal(got, want), f"bag lookup ({name}) differs")
    log(f"bags: {vals.numel()} values in {n_users} bags over "
        f"[{emb['n_items']}, 64], sum and mean, empty and single-value "
        f"bags, unsorted bags: bitwise the plain version")
    # the bag backward
    w = torch.randn(n_users, 64, generator=g).to(device)

    def bag_grad(backend, mode):
        t = v0.detach().clone().requires_grad_(True)
        out = embedding_bag(t, vals, segs, n_users, mode=mode, via=backend)
        return torch.autograd.grad((out * w).sum(), t)[0]

    plain_grad = ref.embedding_bag(w, segs, vals, emb["n_items"])
    require(torch.equal(bag_grad("cuda", "sum"), plain_grad),
            "bag backward is not bitwise the plain backward")
    for mode in ("sum", "mean"):
        a, b_ = bag_grad("cuda", mode), bag_grad("cuda", mode)
        require(torch.equal(a, b_), f"bag backward ({mode}) not "
                f"deterministic")
        gat = bag_grad("gather", mode)
        require(torch.allclose(a, gat, rtol=1e-5, atol=1e-5),
                f"bag backward ({mode}) differs from the gather backend: "
                f"max |diff| {float((a - gat).abs().max())}")
    log("bag backward: bitwise the plain backward (sum), two runs bitwise "
        "equal, within 1e-5 of the gather backend (sum, mean)")

    # the base embeddings' gradient through each backend
    loaded = run["loaded"]
    statics = {"sketch_u": emb["users"]["sketch"],
               "sketch_v": emb["items"]["sketch"]}
    wu = torch.randn(emb["n_users"], 64, generator=g).to(device)
    wv = torch.randn(emb["n_items"], 64, generator=g).to(device)

    def base_grad(backend):
        cfg = dataclasses.replace(loaded.mcfg(), lookup_backend=backend)
        p = {kk: torch.as_tensor(vv, device=device).requires_grad_(True)
             for kk, vv in loaded.params.items()}
        u, v = L._base_embeddings(p, statics, cfg)
        loss = (u * wu).sum() + (v * wv).sum()
        return torch.autograd.grad(loss, [p["user_table"], p["item_table"]])

    a, b_, gat = base_grad("cuda"), base_grad("cuda"), base_grad("gather")
    for name, x, y, z in zip(("user_table", "item_table"), a, b_, gat):
        require(torch.equal(x, y), f"d/d{name} not deterministic")
        require(torch.allclose(x, z, rtol=1e-5, atol=1e-5),
                f"d/d{name} differs from the gather backend: max |diff| "
                f"{float((x - z).abs().max())}")
    log("base-embedding gradients (user and item codebooks): two cuda runs "
        "bitwise equal, within 1e-5 of the gather backend")
    sync(device)
    launches = launch_counts()
    log(f"embedding layer: {time.perf_counter() - t0:.1f} s; kernel "
        f"launches {launches}")
    for name in ("codebook_lookup", "fused_topk_codebook", "embedding_bag"):
        require(launches[name] > 0, f"{name} never ran on the embedding "
                f"layer's path")
    return {"emb": emb, "v0": v0, "launches": launches,
            "readout_cases": n_cases, "near_tie_ids": n_diff,
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phase 4: the kernel bench (dot_interaction's and flash_attention's path)
# ---------------------------------------------------------------------------
def bench_path(device: str = "cuda", fast: bool = False) -> dict:
    """Drives ``repro_torch.launch.kernel_bench`` as a user would
    (``device="cpu"`` with ``fast=True`` rehearses it without a GPU)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import kernel_bench

    t0 = time.perf_counter()
    zero_counts()
    rows = kernel_bench.run(fast=fast, device=device)
    lookup = kernel_bench.bench_backends(device=device)
    fused = kernel_bench.bench_fused(device=device)
    # the bench's attention is f32 (the CUDA-core route); a qwen1.5-32b
    # layer's prefill attention in its bf16 takes the tensor-core route
    b, h, s, d = (1, 40, 4096, 128) if not fast else (1, 2, 256, 128)
    g = torch.Generator(device=device).manual_seed(6)
    q, k, v = (torch.randn(b, h, s, d, generator=g, device=device)
               .to(torch.bfloat16) for _ in range(3))
    out = ops.flash_attention(q, k, v, causal=True)
    require(out.shape == q.shape and bool(torch.isfinite(out).all()),
            "kernel bench: bf16 attention gave non-finite values")
    sync(device)
    launches = launch_counts()
    routes = flash_routes()
    seconds = time.perf_counter() - t0
    metrics = kernel_bench.sweep_metrics(lookup, fused)
    log(f"kernel bench: {seconds:.1f} s; kernel launches {launches}; "
        f"flash_attention by route {routes}")
    err = float(dict(kv.split("=") for kv in rows[-1][2].split(";"))[
        "max_abs_err"])
    require(rows[-1][0] == "kernel/flash_attention_maxerr" and err < 1e-4,
            f"kernel bench: flash_attention differs from ref.mha by {err}")
    require(metrics["lookup_errors"]["value"] == 0,
            "kernel bench: a lookup backend failed")
    # the one refusal expected: the fused kernels' k cap, on the card
    for r in fused:
        cap = re.search(r"k <= (\d+), got k=(\d+)", r.get("error", ""))
        require("error" not in r or (
            device == "cuda" and r["variant"].startswith("fused")
            and cap is not None and int(cap[2]) > int(cap[1])),
            f"kernel bench: the fused sweep failed: {r}")
    for name in ("dot_interaction", "flash_attention"):
        require(launches[name] > 0, f"{name} never ran on the kernel "
                f"bench's path")
    for name, n in routes.items():
        require(device != "cuda" or n > 0, f"flash_attention's {name} route "
                f"never ran on the kernel bench's path")
    return {"rows": [{"name": n, "us_per_call": us, "derived": d}
                     for n, us, d in rows],
            "metrics": metrics, "launches": launches,
            "flash_routes": routes, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 5: each kernel against its plain version
# ---------------------------------------------------------------------------
def check_codebook_lookup(run: dict) -> dict:
    import torch

    from repro_torch.kernels import codebook_lookup, ref
    from repro_torch.kernels import cost as kcost

    dev = torch.device("cuda")
    params = run["loaded"].params
    sketch = run["sketch"]
    max_err = 0.0
    rows = {}
    for side, table, idx in (
            ("users", params["user_table"], sketch.user_idx),
            ("items", params["item_table"], sketch.item_idx)):
        z = torch.as_tensor(table, device=dev)
        ix = torch.as_tensor(idx, dtype=torch.int32, device=dev)
        got = codebook_lookup(z, ix, binary=True)
        want = ref.codebook_lookup(z, ix, binary=True)
        require(torch.equal(got, want),
                f"codebook_lookup ({side}) is not bitwise the plain version")
        max_err = max(max_err, float((got - want).abs().max()))
        b, h = ix.shape
        bms, by = kcost.bound(kcost.codebook_lookup(z, ix, rows=z.shape[0]))
        ixl = ix.long()
        rows[side] = {
            "shape": f"B={b} H={h} K={z.shape[0]} d={z.shape[1]}",
            "ms": time_ms(lambda: codebook_lookup(z, ix, binary=True)),
            "plain_ms": time_ms(lambda: ref.codebook_lookup(z, ix,
                                                            binary=True)),
            "library_ms": time_ms(lambda: z[ixl].sum(1)),
            "bound_ms": bms, "bound_by": by}
        log(f"codebook_lookup {side} {rows[side]['shape']}: bitwise equal; "
            f"{rows[side]}")
    # edge cases: duplicates within rows, H = 1..5 and 40 (a row of more
    # than 32 indices), binary on and off, widths with scalar and float2 /
    # float4 lanes, a codebook not 16-byte aligned, B not a multiple of a
    # strip, B = 0
    g = torch.Generator(device="cpu").manual_seed(0)
    n_cases = 0
    for h in (1, 2, 3, 5, 40):
        for d in (1, 3, 64, 129):
            flat = torch.randn(97 * d + 1, generator=g).to(dev)
            ix = torch.randint(0, 97, (1001, h), generator=g,
                               dtype=torch.int32)
            if h > 1:
                ix[::3, h - 1] = ix[::3, 0]           # forced duplicates
            ix = ix.to(dev)
            for z in (flat[:97 * d].view(97, d), flat[1:].view(97, d)):
                for binary in (False, True):
                    got = codebook_lookup(z, ix, binary=binary)
                    want = ref.codebook_lookup(z, ix, binary=binary)
                    require(torch.equal(got, want),
                            f"codebook_lookup H={h} d={d} binary={binary} "
                            f"differs")
                    n_cases += 1
    empty = codebook_lookup(z, ix[:0], binary=True)
    require(empty.shape == (0, z.shape[1]), "codebook_lookup B=0")
    # the 16-bit instantiations (bf16, f16): 8, 4, 2 and 1 elements a
    # lane, a codebook 2 bytes off alignment, the LM width 3,584
    n16 = 0
    for dtype in (torch.bfloat16, torch.float16):
        for h in (1, 2, 3, 5, 40):
            for d in (1, 3, 64, 130, 3584):
                flat = (torch.randn(97 * d + 1, generator=g) * 4).to(
                    dtype).to(dev)
                ix = torch.randint(0, 97, (257, h), generator=g,
                                   dtype=torch.int32)
                if h > 1:
                    ix[::3, h - 1] = ix[::3, 0]
                ix = ix.to(dev)
                for z16 in (flat[:97 * d].view(97, d), flat[1:].view(97, d)):
                    for binary in (False, True):
                        got = codebook_lookup(z16, ix, binary=binary)
                        require(got.dtype == dtype and torch.equal(
                            got, ref.codebook_lookup(z16, ix, binary=binary)),
                            f"codebook_lookup {dtype} H={h} d={d} "
                            f"binary={binary} differs")
                        n16 += 1
    log(f"codebook_lookup edge cases ({n_cases}: H 1..5 and 40, d 1..129, "
        f"duplicates, binary on/off, unaligned codebook, B=0; {n16} in bf16 "
        f"and f16 at d 1..3,584): bitwise equal")
    main = rows["users"]
    return {"name": "codebook_lookup", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/codebook_lookup.cu",
            "replaces": "src/repro/kernels/codebook_lookup.py:98",
            "launches": (run["launches"]["codebook_lookup"]
                         + run["training"]["launches"]["codebook_lookup"]
                         + run["sharded"]["launches"]["codebook_lookup"]
                         + run["stream"]["launches"]["codebook_lookup"]
                         + run["frontdoor"]["launches"]["codebook_lookup"]
                         + run["baselines"]["launches"]["codebook_lookup"]
                         + run["arch"]["launches"]["codebook_lookup"]
                         + run["lm"]["launches"]["codebook_lookup"]
                         + run["lm_mesh"]["launches"]["codebook_lookup"]
                         + run["arch_mesh"]["launches"]["codebook_lookup"]
                         + run["gnn"]["launches"].get("codebook_lookup", 0)
                         + run["baselines"]["cce"]["launches"][
                             "codebook_lookup"]),
            "launches_by_path": {
                "serving": run["launches"]["codebook_lookup"],
                "training": run["training"]["launches"]["codebook_lookup"],
                "sharded": run["sharded"]["launches"]["codebook_lookup"],
                "stream": run["stream"]["launches"]["codebook_lookup"],
                "frontdoor":
                    run["frontdoor"]["launches"]["codebook_lookup"],
                "baselines":
                    run["baselines"]["launches"]["codebook_lookup"],
                "arch": run["arch"]["launches"]["codebook_lookup"],
                "lm": run["lm"]["launches"]["codebook_lookup"],
                "lm_mesh": run["lm_mesh"]["launches"]["codebook_lookup"],
                "arch_mesh":
                    run["arch_mesh"]["launches"]["codebook_lookup"],
                "gnn": run["gnn"]["launches"].get("codebook_lookup", 0),
                "cce": run["baselines"]["cce"]["launches"][
                    "codebook_lookup"]},
            "max_abs_err": max_err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": main["shape"], "items": rows["items"],
            "items_h2": run["baselines"]["codebook_items_h2"],
            "arch_path": arch_rows(run, "codebook_lookup"),
            "lm_path": {c["cell"]: c["kernels"]["codebook_lookup"]
                        for c in run["lm"]["cells"] + run["lm"]["train"]
                        + [run["lm"]["train_moe"]]},
            "gnn_path": {c["cell"]: c["kernels"]["codebook_lookup"]
                         for c in run["gnn"]["cells"]
                         if "codebook_lookup" in c["kernels"]}}


def check_fused_topk(run: dict) -> dict:
    import numpy as np
    import torch

    from repro_torch.embedding import dequantize_params
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import fused_topk, ref
    from repro_torch.models import lightgcn as L

    dev = torch.device("cuda")
    loaded = run["loaded"]
    params = {k: torch.as_tensor(v, device=dev)
              for k, v in loaded.params.items()}
    statics = loaded.statics(dev)
    u_all, v_all = L.all_embeddings(dequantize_params(params), statics,
                                    loaded.mcfg())
    n, d = v_all.shape
    k = 20
    max_err = 0.0
    per_b = {}

    def compare(u, v, exact=False, block=1024, kk=k, **kw):
        nonlocal max_err
        got_v, got_i = fused_topk(u, v, kk, block=block, **kw)
        want_v, want_i = ref.fused_topk(u, v, kk, **kw)
        torch.cuda.synchronize()
        if exact:
            require(torch.equal(got_i, want_i) and torch.equal(got_v, want_v),
                    f"fused_topk not exact on integer inputs {kw.keys()}")
        else:
            topk_agree(got_v.cpu(), got_i.cpu(), want_v.cpu(), want_i.cpu(),
                       pair_scorer(u, v, kw.get("scale"), kw.get("mask")))
        fin = torch.isfinite(want_v)
        require(torch.equal(fin, torch.isfinite(got_v)),
                "fused_topk -inf pattern differs")
        if fin.any():
            max_err = max(max_err,
                          float((got_v[fin] - want_v[fin]).abs().max()))

    for b in (1, 8, 64, 512):
        u = u_all[:b].contiguous()
        compare(u, v_all)
        one, two = fused_topk(u, v_all, k), fused_topk(u, v_all, k)
        require(torch.equal(one[0], two[0]) and torch.equal(one[1], two[1]),
                f"fused_topk B={b}: two calls differ")
        bms, by = kcost.bound(kcost.fused_topk(u, v_all, k))
        zeros = torch.zeros(n, device=dev)
        per_b[b] = {
            "ms": time_ms(lambda: fused_topk(u, v_all, k)),
            "plain_ms": time_ms(lambda: ref.fused_topk(u, v_all, k)),
            "library_ms": time_ms(
                lambda: torch.topk(u @ v_all.T + zeros, k)),
            "bound_ms": bms, "bound_by": by}
        log(f"fused_topk B={b} N={n} d={d} k={k}: agrees; {per_b[b]}")

    g = torch.Generator(device="cpu").manual_seed(1)
    # integer-valued scores: exact, with ties everywhere (tie order)
    ui = torch.randint(-2, 3, (64, 64), generator=g).float().to(dev)
    vi = torch.randint(-2, 3, (5000, 64), generator=g).float().to(dev)
    compare(ui, vi, exact=True)
    compare(ui, vi, exact=True, block=37)
    # fewer than k finite scores: fill with the lowest-id -inf items
    mask = torch.full((5000,), float("-inf"), device=dev)
    mask[torch.randperm(5000, generator=g)[:7].to(dev)] = 0.0
    compare(ui, vi, exact=True, mask=mask)
    # exclusions (including each row's true top items)
    _, top = ref.fused_topk(ui, vi, k)
    rows = torch.arange(64, device=dev).repeat_interleave(5)
    cols = top[:, :5].reshape(-1).long()
    extra_r = torch.randint(0, 64, (300,), generator=g).to(dev)
    extra_c = torch.randint(0, 5000, (300,), generator=g).to(dev)
    excl = (torch.cat([rows, extra_r]), torch.cat([cols, extra_c]))
    compare(ui, vi, exact=True, exclude=excl)
    compare(ui, vi, exact=True, exclude=excl, mask=mask)
    # int8 items with per-row scale: exact with power-of-two scales,
    # near-tie agreement with random ones
    q = torch.randint(-127, 128, (5000, 64), generator=g,
                      dtype=torch.int8).to(dev)
    pow2 = (2.0 ** torch.randint(-3, 2, (5000,), generator=g)).float().to(dev)
    compare(ui, q, exact=True, scale=pow2)
    sc = (torch.rand(5000, generator=g) * 0.02 + 1e-3).to(dev)
    compare(u_all[:64].contiguous(), q, scale=sc)
    # the main path's int8 tables, dequantized then propagated
    qp = {kk: torch.as_tensor(vv, device=dev)
          for kk, vv in loaded.quantize().serving_params().items()}
    uq, vq = L.all_embeddings(dequantize_params(qp), statics, loaded.mcfg())
    compare(uq[:512].contiguous(), vq)
    # k above one key a lane (lists of 64 and 128 keys): exact on integer
    # inputs, with < k finite scores and with exclusions (the rows' shared
    # bounds at 64 rows and k 100, 128, not at 5 rows), near-ties on the
    # main path's embeddings at B 64 and 512 (bounds shared); k 64, 100 and
    # 128 timed at B = 512
    for kk in (33, 64, 100, 128):
        compare(ui, vi, exact=True, kk=kk)
        compare(ui, vi, exact=True, kk=kk, block=37, mask=mask)
        compare(ui, vi, exact=True, kk=kk, exclude=excl)
        compare(ui, q, exact=True, kk=kk, scale=pow2)
        compare(ui[:5].contiguous(), vi, exact=True, kk=kk, block=37)
        compare(u_all[:64].contiguous(), v_all, kk=kk)
        compare(u_all[:512].contiguous(), v_all, block=None, kk=kk)
    u512 = u_all[:512].contiguous()
    zeros = torch.zeros(n, device=dev)
    long_k = {}
    for kk in (64, 100, 128):
        bms, by = kcost.bound(kcost.fused_topk(u512, v_all, kk))
        long_k[str(kk)] = {
            "shape": f"B=512 N={n} d={d} k={kk}",
            "ms": time_ms(lambda: fused_topk(u512, v_all, kk)),
            "plain_ms": time_ms(lambda: ref.fused_topk(u512, v_all, kk)),
            "library_ms": time_ms(
                lambda: torch.topk(u512 @ v_all.T + zeros, kk)),
            "bound_ms": bms, "bound_by": by}
    log(f"fused_topk k=33..128: agrees (exact on integer inputs); B=512 "
        f"k=64, 100, 128: {long_k}")
    # k above the cap is refused
    try:
        fused_topk(ui, vi, 129)
        raise SmokeFailure("fused_topk accepted k above its cap")
    except ValueError:
        pass
    check_nan_order(ui, vi)
    log("fused_topk edge cases (ties, <k finite, exclusions, int8, k up "
        "to 128, k cap, NaN scores): pass")
    main = per_b[512]
    return {"name": "fused_topk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_topk.cu",
            "replaces": "src/repro/kernels/fused_topk.py:229",
            "launches": (run["launches"]["fused_topk"]
                         + run["stream"]["launches"]["fused_topk"]
                         + run["frontdoor"]["launches"]["fused_topk"]
                         + run["baselines"]["launches"]["fused_topk"]),
            "launches_by_path": {
                "serving": run["launches"]["fused_topk"],
                "stream": run["stream"]["launches"]["fused_topk"],
                "frontdoor": run["frontdoor"]["launches"]["fused_topk"],
                "baselines": run["baselines"]["launches"]["fused_topk"]},
            "max_abs_err": max_err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": f"B=512 N={n} d={d} k={k}",
            "by_batch": {str(b): per_b[b] for b in per_b},
            "long_k": long_k}


def check_nan_order(u, items, sketch=None) -> None:
    """NaN scores (a NaN query row, NaN item rows) rank first, lowest id
    first, in the kernel as in the plain version."""
    import torch

    from repro_torch.kernels import fused_topk, ref

    u = u.clone()
    items = items.clone()
    u[3] = float("nan")
    nan_rows = [7, 123, items.shape[0] - 1]
    items[nan_rows] = float("nan")
    if sketch is not None:                 # items that expand NaN rows
        sketch = sketch.clone()
        sketch[[5, 50, sketch.shape[0] - 1], 0] = torch.tensor(
            nan_rows, dtype=torch.int32, device=sketch.device)
    got = fused_topk(u, items, 20, sketch=sketch, block=61)
    want = ref.fused_topk(u, items, 20, sketch=sketch)
    require(torch.equal(got[1], want[1]) and torch.equal(
        torch.isnan(got[0]), torch.isnan(want[0])) and torch.equal(
        got[0].nan_to_num(), want[0].nan_to_num()),
        f"fused_topk ({'codebook' if sketch is not None else 'dense'}) "
        f"orders NaN scores unlike the plain version")
    require(bool(torch.isnan(got[0][:, 0]).all()), "NaN does not rank first")


def check_fused_topk_codebook(run: dict, emb_run: dict) -> dict:
    import torch

    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import fused_topk_codebook, ref

    emb = emb_run["emb"]
    dev = emb["values"].device
    k = 20
    max_err = 0.0
    rows = {}
    g = torch.Generator(device="cpu").manual_seed(3)
    for side in ("items", "users"):
        tab = emb[side]
        sk = tab["sketch"]
        n, h = sk.shape
        kz, d = tab["z"].shape
        mask = torch.zeros(n, device=dev)
        per_b = {}
        for b in (1, 8, 64, 512):
            for quant in (False, True):
                z = tab["q"] if quant else tab["z"]
                scale = tab["scale"] if quant else None
                u = torch.randn(b, d, generator=g).to(dev)
                got = fused_topk_codebook(u, z, sk, k, scale=scale, mask=mask)
                again = fused_topk_codebook(u, z, sk, k, scale=scale,
                                            mask=mask)
                require(torch.equal(got[0], again[0])
                        and torch.equal(got[1], again[1]),
                        f"fused_topk_codebook {side} B={b}: two calls differ")
                want = ref.fused_topk(u, z, k, sketch=sk, scale=scale,
                                      mask=mask)
                exp = ref.expand_items(z, scale, sk)
                topk_agree(got[0].cpu(), got[1].cpu(), want[0].cpu(),
                           want[1].cpu(), pair_scorer(u, exp, mask=mask))
                max_err = max(max_err,
                              float((got[0] - want[0]).abs().max()))
                if quant:
                    continue
                bms, by = kcost.bound(kcost.fused_topk_codebook(u, z, sk, k,
                                                          mask=mask))
                per_b[b] = {
                    "ms": time_ms(lambda: fused_topk_codebook(
                        u, z, sk, k, mask=mask)),
                    "plain_ms": time_ms(lambda: ref.fused_topk(
                        u, z, k, sketch=sk, mask=mask), iters=10),
                    "library_ms": time_ms(lambda: torch.topk(
                        u @ ref.expand_items(z, None, sk).T + mask, k)),
                    "bound_ms": bms, "bound_by": by}
                log(f"fused_topk_codebook {side} B={b} N={n} K={kz} H={h} "
                    f"d={d} k={k}: agrees (f32, int8); {per_b[b]}")
        rows[side] = {"shape": f"B=512 N={n} K={kz} H={h} d={d} k={k}",
                      "by_batch": {str(b): per_b[b] for b in per_b}}
        int_u = torch.randint(-2, 3, (64, 64), generator=g).float().to(dev)
        check_nan_order(int_u, tab["z"][:5000].contiguous(), sk[:3000] % 5000)
    log("fused_topk_codebook NaN scores: same order as the plain version")
    main = rows["items"]["by_batch"]["512"]
    return {"name": "fused_topk_codebook", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_topk.cu",
            "replaces": "src/repro/kernels/fused_topk.py:347",
            "launches": emb_run["launches"]["fused_topk_codebook"],
            "max_abs_err": max_err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": rows["items"]["shape"], "by_side": rows}


def csr_ptr(sorted_rows, n: int):
    """int64 [n + 1] CSR boundaries of the runs of 0..n-1 in
    ``sorted_rows`` (what the bag and scatter wrappers build)."""
    import torch
    return torch.searchsorted(sorted_rows,
                              torch.arange(n + 1, device=sorted_rows.device))


def csr_cases(emb: dict, table, seed: int = 11) -> dict:
    """The CSR gather-sum's (src, idx, ptr) as the embedding path hands
    them to the kernel: the bag forward (every user's bag of training
    items over ``table``), the bag backward (``scatter_rows`` into the
    item rows) and the codebook gradients of both sides (``scatter_rows``
    into K_u and K_v rows, binary-Y duplicates dropped), with seeded
    normal cotangents."""
    import torch

    from repro_torch.kernels import ref

    dev = table.device
    d = table.shape[1]
    g = torch.Generator(device="cpu").manual_seed(seed)
    vals, segs = emb["values"], emb["segments"]
    n_users, n_items = emb["n_users"], emb["n_items"]
    cases = {"forward": (table, vals, csr_ptr(segs, n_users))}
    w = torch.randn(n_users, d, generator=g).to(dev)
    dest, perm = torch.sort(vals.long(), stable=True)
    cases["bag_backward"] = (w, segs[perm].int(), csr_ptr(dest, n_items))
    for side in ("users", "items"):
        sk = emb[side]["sketch"]
        b, h = sk.shape
        k_rows = emb[side]["z"].shape[0]
        cot = torch.randn(b, d, generator=g).to(dev)
        dest = sk.reshape(-1).long()
        src = torch.arange(b * h, device=dev) // h
        if h > 1:
            keep = ref.dedup_keep_mask(sk).reshape(-1)
            dest, src = dest[keep], src[keep]
        dest, perm = torch.sort(dest, stable=True)
        cases[f"codebook_{side}"] = (cot, src[perm].int(),
                                     csr_ptr(dest, k_rows))
    return cases


def skewed_csr(rows: int, n_src: int, g, device, longest: int = 4000,
               mid: int = 200):
    """(idx int32, ptr int64) of power-law-like bags over ``n_src``
    source rows: ``longest`` values in the first and the last bag,
    ``mid`` bags of 300-600 values at random rows, the rest 0-3 values."""
    import torch
    lens = torch.randint(0, 4, (rows,), generator=g)
    pos = torch.randperm(rows - 2, generator=g)[:mid] + 1
    lens[pos] = torch.randint(300, 601, (len(pos),), generator=g)
    lens[0] = lens[-1] = longest
    ptr = torch.zeros(rows + 1, dtype=torch.int64)
    ptr[1:] = torch.cumsum(lens, 0)
    idx = torch.randint(0, n_src, (int(ptr[-1]),), generator=g,
                        dtype=torch.int32)
    return idx.to(device), ptr.to(device)


def csr_row(src, idx, ptr) -> dict:
    """Times and bound of one CSR gather-sum call; the library call is
    ``zeros(S, d).index_add_(0, row_of_each_value, src[idx])``."""
    import torch

    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import csr_gather_sum, ref

    n_seg = ptr.numel() - 1
    n, d = src.shape
    nnz = idx.numel()
    bms, by = kcost.bound(kcost.csr_gather_sum(src, idx, ptr, rows=n))
    seg = torch.repeat_interleave(torch.arange(n_seg, device=src.device),
                                  ptr[1:] - ptr[:-1])
    idl = idx.long()
    lens = ptr[1:] - ptr[:-1]
    return {"shape": f"nnz={nnz} S={n_seg} N={n} d={d} "
                     f"longest={int(lens.max())}",
            "ms": time_ms(lambda: csr_gather_sum(src, idx, ptr)),
            "plain_ms": time_ms(lambda: ref.csr_gather_sum(src, idx, ptr),
                                iters=5),
            "library_ms": time_ms(lambda: torch.zeros(
                n_seg, d, device=src.device).index_add_(0, seg, src[idl])),
            "bound_ms": bms, "bound_by": by}


def check_embedding_bag(run: dict, emb_run: dict) -> dict:
    import torch

    from repro_torch.kernels import csr_gather_sum, ref
    from repro_torch.kernels.embedding_bag import scatter_rows

    emb = emb_run["emb"]
    cases = csr_cases(emb, emb_run["v0"])
    max_err = 0.0
    rows = {}
    for name, (src, idx, ptr) in cases.items():
        got = csr_gather_sum(src, idx, ptr)
        want = ref.csr_gather_sum(src, idx, ptr)
        require(torch.equal(got, want),
                f"embedding_bag kernel ({name}) is not bitwise its plain "
                f"version")
        require(torch.equal(got, csr_gather_sum(src, idx, ptr)),
                f"embedding_bag kernel ({name}): two calls differ")
        max_err = max(max_err, float((got - want).abs().max()))
        rows[name] = csr_row(src, idx, ptr)
        log(f"embedding_bag {name} {rows[name]['shape']}: bitwise; "
            f"{rows[name]}")
    # the backward case is what scatter_rows hands the kernel
    w = cases["bag_backward"][0]
    require(torch.equal(scatter_rows(w, emb["values"], emb["segments"],
                                     emb["n_items"]),
                        ref.embedding_bag(w, emb["segments"], emb["values"],
                                          emb["n_items"])),
            "scatter_rows is not bitwise the plain bag backward")
    # edge cases: skewed bags (4,000 values at the first and last rows,
    # 200 of 300-600, the rest 0-3), widths with scalar and float2 /
    # float4 lanes and column tiles, a source not 16-byte aligned, all
    # bags empty, no rows
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(4)
    n_cases = 0
    for d in (1, 3, 50, 64, 129, 256, 600):
        idx, ptr = skewed_csr(3000, 1000, g, dev)
        flat = torch.randn(1000 * d + 1, generator=g).to(dev)
        for src in (flat[:1000 * d].view(1000, d),
                    flat[1:].view(1000, d)):          # 4 bytes off
            got = csr_gather_sum(src, idx, ptr)
            require(torch.equal(got, ref.csr_gather_sum(src, idx, ptr)),
                    f"embedding_bag skewed bags d={d} differ")
            n_cases += 1
    src = torch.randn(10, 64, device=dev)
    for idx, ptr in ((torch.zeros(0, dtype=torch.int32, device=dev),
                      torch.zeros(7, dtype=torch.int64, device=dev)),
                     (torch.zeros(0, dtype=torch.int32, device=dev),
                      torch.zeros(1, dtype=torch.int64, device=dev))):
        got = csr_gather_sum(src, idx, ptr)
        require(got.shape == (ptr.numel() - 1, 64) and not got.any(),
                "embedding_bag: empty bags are not zero rows")
        n_cases += 1
    log(f"embedding_bag edge cases ({n_cases}: skewed bags, d 1..600, "
        f"unaligned source, empty bags, no rows): bitwise equal")
    weighted = check_weighted(run)
    main = rows["forward"]
    path_launches = {
        "serving": run["launches"]["embedding_bag"],
        "training": run["training"]["launches"]["embedding_bag"],
        "sharded": run["sharded"]["launches"]["embedding_bag"],
        "embedding_layer": emb_run["launches"]["embedding_bag"],
        "stream": run["stream"]["launches"]["embedding_bag"],
        "frontdoor": run["frontdoor"]["launches"]["embedding_bag"],
        "cluster": run["cluster_launches"],
        "scale": run["scale"]["launches"]["embedding_bag"],
        "baselines": run["baselines"]["launches"]["embedding_bag"],
        "arch": run["arch"]["launches"].get("embedding_bag", 0),
        "lm (bf16)": run["lm"]["launches"].get("embedding_bag", 0),
        "lm_mesh": run["lm_mesh"]["launches"].get("embedding_bag", 0),
        "arch_mesh": run["arch_mesh"]["launches"].get("embedding_bag", 0),
        "gnn": run["gnn"]["launches"].get("embedding_bag", 0),
        "cce": run["baselines"]["cce"]["launches"].get("embedding_bag", 0)}
    return {"name": "embedding_bag", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
            "replaces": "src/repro/kernels/embedding_bag.py:56",
            "launches": sum(path_launches.values()),
            "launches_by_path": path_launches,
            "weighted_per_train_step": run["training"]["weighted_per_step"],
            "weighted_per_request": run["weighted_per_request"],
            "max_abs_err": max_err,
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "shape")},
            "backward": {k: rows[k] for k in rows if k != "forward"},
            "weighted": weighted,
            "segment_sum": {r: run["scale"][r]["segment_sum"]
                            for r in run["scale"]
                            if "segment_sum" in run["scale"].get(r, {})},
            "arch_path": arch_rows(run, "embedding_bag"),
            "gnn_path": {f"{c['cell']} {k}": row
                         for c in run["gnn"]["cells"]
                         for k, row in c["kernels"].items()
                         if k.startswith("embedding_bag")}}


def check_embedding_bag16(run: dict) -> dict:
    """The CSR gather-sum's bf16 instantiation on the LM path: the token
    lookup's backward in the LM train cells, the MoE's token combine in
    every MoE request and train step, and its dispatch gather's
    gradient. Its launches by cell, and each cell's first call of each
    role held bitwise against the plain version and timed
    (:func:`lm_cell`, :func:`lm_train_cell`); the lead row is the dense
    train cell's first token gradient. bf16 and f16 at the ``cuda``
    tests' shapes are held by ``tests/test_torch_cuda.py`` and
    ``tools/gather_parity.py``."""
    lm = run["lm"]
    row = lm["train"][0]["kernels"]["embedding_bag"]
    cells = lm["cells"] + lm["train"] + [lm["train_moe"]]
    by_path = {c["cell"]: c["launches_bf16_gather_sum"] for c in cells
               if c["launches_bf16_gather_sum"]}
    mesh = run["lm_mesh"]
    by_path.update({f"lm_mesh {c['cell']}": c["launches_bf16_gather_sum"]
                    for c in mesh["decode"] + [mesh["train"], mesh["gpipe"]]
                    if c["launches_bf16_gather_sum"]})
    roles = {f"{c['cell']} {k}": r for c in cells
             for k, r in c["kernels"].items() if k.startswith("embedding_bag")}
    return {"name": "embedding_bag_bf16", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
            "replaces": "src/repro/kernels/embedding_bag.py:56",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in roles.values()),
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "shape")},
            "lm_path": roles}


def cumsum_route(src_t, idx, w, ptr):
    """The propagation's segment sum as the port computed it before the
    weighted kernel (a yardstick only): layers kept as [d, n], the edge
    rows gathered and weighted as columns, a cumsum along the edges and a
    boundary difference."""
    import torch
    c = torch.cumsum(torch.nn.functional.pad(src_t[:, idx] * w, (1, 0)),
                     dim=1)
    return c[:, ptr[1:]] - c[:, ptr[:-1]]


def weighted_row(src, idx, w, ptr) -> dict:
    """Times and bound of one weighted CSR gather-sum call: the bound
    reads the source table once, idx, w and ptr, and writes out; the
    library call is ``zeros(S, d).index_add_(0, seg, src[idx] * w)``, and
    ``cumsum_ms`` the previous cumsum route."""
    import torch

    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import csr_gather_sum, ref

    n_seg = ptr.numel() - 1
    n, d = src.shape
    nnz = idx.numel()
    bms, by = kcost.bound(kcost.csr_gather_sum(src, idx, ptr, w, rows=n))
    seg = torch.repeat_interleave(torch.arange(n_seg, device=src.device),
                                  ptr[1:] - ptr[:-1])
    idl = idx.long()
    src_t = src.T.contiguous()
    lens = ptr[1:] - ptr[:-1]
    return {"shape": f"nnz={nnz} S={n_seg} N={n} d={d} "
                     f"longest={int(lens.max())} weighted",
            "ms": time_ms(lambda: csr_gather_sum(src, idx, ptr, w)),
            "plain_ms": time_ms(
                lambda: ref.csr_gather_sum(src, idx, ptr, w), iters=5),
            "library_ms": time_ms(lambda: torch.zeros(
                n_seg, d, device=src.device).index_add_(
                0, seg, src[idl] * w[:, None])),
            "cumsum_ms": time_ms(lambda: cumsum_route(src_t, idl, w, ptr)),
            "bound_ms": bms, "bound_by": by}


def check_weighted(run: dict, device: str = "cuda") -> dict:
    """The weighted CSR gather-sum (the LightGCN propagation) bitwise
    against its plain version at the propagation's two shapes, through
    ``_Propagate`` forward and backward, and on edge cases; timed at both
    shapes."""
    import torch

    from repro_torch.kernels import csr_gather_sum, ref
    from repro_torch.models import lightgcn as L

    dev = torch.device(device)
    train = run["train"]
    statics = run["loaded"].statics(dev)
    user_side, item_side = L._kernel_edges(statics)
    g = torch.Generator(device="cpu").manual_seed(12)
    cu = torch.randn(train.n_users, 64, generator=g).to(dev)
    cv = torch.randn(train.n_items, 64, generator=g).to(dev)
    rows = {}
    for name, src, (idx, w, ptr) in (("user_side", cv, user_side),
                                     ("item_side", cu, item_side)):
        got = csr_gather_sum(src, idx, ptr, w)
        require(torch.equal(got, ref.csr_gather_sum(src, idx, ptr, w)),
                f"weighted CSR gather-sum ({name}) is not bitwise its plain "
                f"version")
        require(torch.equal(got, csr_gather_sum(src, idx, ptr, w)),
                f"weighted CSR gather-sum ({name}): two calls differ")
        rows[name] = weighted_row(src, idx, w, ptr)
        log(f"embedding_bag weighted {name} {rows[name]['shape']}: bitwise; "
            f"{rows[name]}")
    # through the propagation's autograd function, forward and backward
    a, b = cu.clone().requires_grad_(True), cv.clone().requires_grad_(True)
    nu, nv = L._Propagate.apply(a, b, statics)
    gu = torch.randn(nu.shape, generator=g).to(dev)
    gv = torch.randn(nv.shape, generator=g).to(dev)
    d_cu, d_cv = torch.autograd.grad((nu * gu).sum() + (nv * gv).sum(),
                                     [a, b])
    plain = {"nu": ref.csr_gather_sum(cv, *user_side[:1], user_side[2],
                                      user_side[1]),
             "nv": ref.csr_gather_sum(cu, item_side[0], item_side[2],
                                      item_side[1]),
             "d_cv": ref.csr_gather_sum(gu, item_side[0], item_side[2],
                                        item_side[1]),
             "d_cu": ref.csr_gather_sum(gv, user_side[0], user_side[2],
                                        user_side[1])}
    for name, got in (("nu", nu), ("nv", nv), ("d_cu", d_cu),
                      ("d_cv", d_cv)):
        require(torch.equal(got, plain[name]),
                f"_Propagate {name} is not bitwise the plain version")
    log("_Propagate forward and backward at full width: bitwise the plain "
        "version")
    # edge cases: empty rows, w = 0 and -0.0, negative weights, rows of
    # more than 32 values, one row of 100,000 values; widths of scalar,
    # float2 and float4 lanes, and a column tile
    n_cases = 0
    for d in (1, 3, 64, 129, 600):
        idx, ptr = skewed_csr(3000, 1000, g, dev)
        w = torch.randn(idx.numel(), generator=g)
        w[::5] = 0.0
        w[::7] = -0.0
        w = w.to(dev)
        src = torch.randn(1000, d, generator=g).to(dev)
        require(torch.equal(csr_gather_sum(src, idx, ptr, w),
                            ref.csr_gather_sum(src, idx, ptr, w)),
                f"weighted skewed bags d={d} differ")
        n_cases += 1
    src = torch.randn(1000, 64, generator=g).to(dev)
    idx = torch.randint(0, 1000, (100_000,), generator=g,
                        dtype=torch.int32).to(dev)
    w = torch.randn(100_000, generator=g).to(dev)
    ptr = torch.tensor([0, 100_000, 100_000], device=dev)
    require(torch.equal(csr_gather_sum(src, idx, ptr, w),
                        ref.csr_gather_sum(src, idx, ptr, w)),
            "weighted row of 100,000 values differs")
    zero = csr_gather_sum(src, idx, ptr, torch.full_like(w, -0.0))
    require(not zero.any() and not zero.signbit().any(),
            "-0.0 weights do not sum to +0.0")
    log(f"weighted edge cases ({n_cases + 2}: skewed bags with zero, -0.0 "
        f"and negative weights, d 1..600, one row of 100,000 values, "
        f"all -0.0 weights): bitwise equal")
    return rows


def check_close(got, want, dtype, what: str) -> float:
    """Kernel output against its plain version at the stated tolerance;
    returns max |err|. f32: rtol 2e-4 / atol 2e-5. bf16 and f16: both
    sides compute in f32 and round once, so they may differ by one step
    of the type's rounding: rtol 1.5 x its eps (bf16 1.17e-2, f16
    1.46e-3) and atol 1e-4."""
    import torch
    tol = ({"rtol": 2e-4, "atol": 2e-5} if dtype == torch.float32
           else {"rtol": 1.5 * torch.finfo(dtype).eps, "atol": 1e-4})
    require(got.dtype == want.dtype and got.shape == want.shape,
            f"{what}: dtype or shape differs from the plain version")
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    require(bool(torch.isfinite(g).all()) and torch.allclose(g, w, **tol),
            f"{what}: differs from the plain version, max |err| {err}")
    return err


# (B, F, d, dtype): dlrm-mlperf (26 sparse fields + the bottom-MLP vector,
# d 128) at its training batch in f32 (the row of the kernels line) and
# bf16; the kernel bench's --full batch; serve_p99's batch; an f16 check
DOT_SHAPES = [(65536, 27, 128, "float32"), (65536, 27, 128, "bfloat16"),
              (2048, 27, 128, "float32"), (512, 27, 128, "float32"),
              (2048, 27, 128, "float16")]


def check_dot_interaction(bench_run: dict, run: dict,
                          device: str = "cuda") -> dict:
    import torch

    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import dot_interaction, ref

    g = torch.Generator(device=device).manual_seed(4)
    rows, max_err = {}, 0.0
    for b, f, d, dtype in DOT_SHAPES:
        dt = getattr(torch, dtype)
        shape = f"B={b} F={f} d={d} {dtype}"
        x = torch.randn(b, f, d, generator=g, device=device).to(dt)
        err = check_close(dot_interaction(x), ref.dot_interaction(x), dt,
                          f"dot_interaction {shape}")
        max_err = max(max_err, err)
        xi = torch.randint(-3, 4, (b, f, d), generator=g,
                           device=device).to(dt)
        require(torch.equal(dot_interaction(xi), ref.dot_interaction(xi)),
                f"dot_interaction {shape} not exact on integer inputs")
        bms, by = kcost.bound(kcost.dot_interaction(x))
        i, j = torch.tril_indices(f, f, -1, device=x.device)
        rows[shape] = {
            "ms": time_ms(lambda: dot_interaction(x)),
            "plain_ms": time_ms(lambda: ref.dot_interaction(x), iters=10),
            "library_ms": time_ms(
                lambda: torch.bmm(x, x.transpose(1, 2))[:, i, j]),
            "bound_ms": bms, "bound_by": by, "max_abs_err": err}
        log(f"dot_interaction {shape}: agrees, exact on integer inputs; "
            f"{rows[shape]}")
    xs = torch.randint(-3, 4, (27, 512, 128), generator=g,
                       device=device).float().transpose(0, 1)
    require(torch.equal(dot_interaction(xs), ref.dot_interaction(xs)),
            "dot_interaction differs on a strided input")
    if device == "cuda":                 # the plain version has no cap
        try:
            dot_interaction(torch.zeros(2, 500, 128, device=device))
            raise SmokeFailure("dot_interaction accepted a tile beyond "
                               "shared memory")
        except ValueError:
            pass
    log("dot_interaction edge cases (strided input, tile cap): pass")
    # the model path's recorded call gives the lead row; the shapes above
    # stand beside it
    entry = {"name": "dot_interaction", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/dot_interaction.cu",
             "replaces": "src/repro/kernels/dot_interaction.py:45",
             **arch_entry(run, "dot_interaction",
                          bench_run["launches"]["dot_interaction"]),
             "by_shape": rows}
    entry["max_abs_err"] = max(entry["max_abs_err"], max_err)
    return entry


# (B, H, Sq, Skv, d, dtype, causal, timed): one layer of qwen1.5-32b (40
# heads of 128) at train_4k's sequence, batch 1 (the row of the kernels
# line); the kernel bench's --full shape, causal and not; the paths'
# attention (``models/recsys.py``): SASRec train and serve (-baco
# published config: d 50, one head, 49 or 50 positions, causal) and
# BERT4Rec serve (d 64 over 2 heads, 200 positions, full); SASRec's d 50
# with Sq != Skv, f16, and bf16 at d 256 (the CUDA-core route), checked
# only
FLASH_SHAPES = [(1, 40, 4096, 4096, 128, "bfloat16", True, True),
                (2, 8, 2048, 2048, 128, "float32", True, True),
                (2, 8, 2048, 2048, 128, "float32", False, True),
                (65536, 1, 49, 49, 50, "float32", True, True),
                (512, 1, 50, 50, 50, "float32", True, True),
                (512, 2, 200, 200, 32, "float32", False, True),
                (4, 2, 200, 328, 50, "float32", True, False),
                (1, 8, 1024, 1024, 128, "float16", True, False),
                (2, 4, 200, 328, 50, "bfloat16", True, False),
                (1, 4, 512, 512, 256, "bfloat16", True, False)]


def check_flash_attention(bench_run: dict, run: dict,
                          device: str = "cuda") -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import flash_attention, ref
    from repro_torch.kernels.flash_attention import route

    g = torch.Generator(device=device).manual_seed(5)
    rows, max_err = {}, 0.0
    for b, h, sq, skv, d, dtype, causal, timed in FLASH_SHAPES:
        dt = getattr(torch, dtype)
        shape = (f"B={b} H={h} Sq={sq} Skv={skv} d={d} {dtype} "
                 f"{'causal' if causal else 'full'}")
        q, k, v = (torch.randn(b, h, s, d, generator=g, device=device).to(dt)
                   for s in (sq, skv, skv))
        before = flash_routes()
        got = flash_attention(q, k, v, causal=causal)
        ran = [r for r, n in flash_routes().items() if n > before[r]]
        want_route = route(dt, d)
        require(device != "cuda" or ran == [want_route],
                f"flash_attention {shape}: ran route {ran}, not "
                f"{want_route}")
        err = check_close(got, ref.flash_attention(q, k, v, causal=causal),
                          dt, f"flash_attention {shape}")
        max_err = max(max_err, err)
        if not timed:
            log(f"flash_attention {shape}: route {want_route}, agrees, max "
                f"|err| {err}")
            continue
        # f32: every operation at the f32 rate; 16-bit: every product at
        # the tensor rate (q·kᵀ multiplies two inputs, and the kernel runs
        # P·V on the tensor cores too, P split in two 16-bit halves)
        bms, by = kcost.bound(kcost.flash_attention(q, k, v, causal=causal))
        rows[shape] = {
            "route": want_route,
            "ms": time_ms(lambda: flash_attention(q, k, v, causal=causal)),
            "plain_ms": time_ms(lambda: ref.flash_attention(
                q, k, v, causal=causal), iters=5, warmup=1),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal)),
            "bound_ms": bms, "bound_by": by, "max_abs_err": err}
        log(f"flash_attention {shape}: agrees; {rows[shape]}")
    # strided [B, S, H, d] views, as a model's layout passes them
    qs, ks, vs = (torch.randn(2, 256, 4, 64, generator=g,
                              device=device).transpose(1, 2)
                  for _ in range(3))
    max_err = max(max_err, check_close(
        flash_attention(qs, ks, vs), ref.flash_attention(qs, ks, vs),
        torch.float32, "flash_attention on strided inputs"))
    log("flash_attention edge cases (d=50, Sq != Skv, f16, bf16 d=256, "
        "strided): pass")
    # the model path's recorded call gives the lead row; the shapes above
    # stand beside it
    entry = {"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:87",
             **arch_entry(run, "flash_attention",
                          bench_run["launches"]["flash_attention"]),
             "by_shape": rows}
    entry["max_abs_err"] = max(entry["max_abs_err"], max_err)
    return entry


# ---------------------------------------------------------------------------
# phase 7: the benches, through the results store
# ---------------------------------------------------------------------------
def bench_errors(bench: str, payload: dict) -> tuple:
    """(failures, refusals) of a bench's rows. A refusal is a kernel-bench
    fused row whose k lies above the fused kernels' declared cap (the
    sweep's k = 100 shape, which the reference's kernel serves): it is
    counted and reported, not passed over. Any other error row, and any
    state allocated under load or on a swap, is a failure."""
    if bench in ("train_pipeline", "serve_session"):
        return [r for r in payload["records"] if "error" in r], []
    if bench == "kernel":
        bad = [r for r in payload["codebook_lookup"] if "error" in r]
        refused = []
        for r in payload["fused"]:
            if "error" not in r:
                continue
            cap = re.search(r"k <= (\d+), got k=(\d+)", r["error"])
            if cap and int(cap[2]) > int(cap[1]):
                refused.append({k: r.get(k) for k in (
                    "variant", "B", "N", "d", "K", "error")})
            else:
                bad.append(r)
        return bad, refused
    if bench == "server":
        return [k for k in ("failed", "state_allocations_under_load")
                if payload[k]] + (["swap_mode"] if payload["swap_mode"]
                                  != "swapped" else []), []
    if bench == "stream":
        return [k for k in ("swap_state_allocations", "capacity_bumps")
                if payload[k]], []
    if bench == "cluster_scale":
        return [r["rung"] for r in payload["rungs"]
                if not r.get("bitwise_equal_inmem", True)], []
    return [], []


def run_bench(module: str, argv: list) -> tuple:
    """``main(argv)`` of ``repro_torch.launch.<module>`` with its stdout
    captured: (exit code, seconds, captured text)."""
    import importlib
    mod = importlib.import_module(f"repro_torch.launch.{module}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, time.perf_counter() - t0, buf.getvalue()


def declared(metrics: dict) -> bool:
    return bool(metrics) and all(
        isinstance(m, dict) and isinstance(m.get("higher_is_better"), bool)
        for m in metrics.values())


def benches_path(workdir: str, device: str = "cuda", bench_args=None,
                 profile_args=None, replay_bench: str = "kernel") -> dict:
    """Each bench CLI of the port (``BENCH_ARGS``) as a user calls it,
    into a fresh store under ``workdir`` (never the default root): each
    must append exactly one record with a fingerprint of this card and
    every metric's direction declared, and no error row. Launch counts
    are zeroed before each bench and read after it; over the phase,
    codebook_lookup, fused_topk, its codebook variant and the CSR
    gather-sum must have run. One bench is then called again (a cache hit
    that appends nothing) and with ``--force`` (it appends), the serving
    roofline is derived from the newest kernel record, the train bench
    runs once more under ``--trace --profile`` (``PROFILE_ARGS``, not
    stored): its Chrome trace must hold device events, the
    codebook_lookup and CSR gather-sum kernels among them, and the
    ``obs_report`` rollup of its spans ``cluster_solve`` under
    ``fit_gamma``. Last, ``bench_summary --check`` on the store: its
    verdicts are printed, and a warning fails nothing (two records a
    minute apart are no trajectory), but an exception or an undeclared
    direction does."""
    from repro_torch.launch import bench_summary
    from repro_torch.obs import get_tracer, set_tracer
    from repro_torch.obs.report import read_trace, rollup
    from repro_torch.obs.trace import Tracer
    from repro_torch.launch.obs_report import report as obs_report
    from repro_torch.results import ResultsStore

    args = bench_args or BENCH_ARGS
    store_dir = os.path.join(workdir, "bench_store")
    store = ResultsStore(store_dir)
    common = ["--device", device, "--store", store_dir]
    out, total = {}, {name: 0 for name in counted_kernels()}
    t_phase = time.perf_counter()
    for bench, (module, argv) in args.items():
        zero_counts()
        rc, seconds, _ = run_bench(module, list(argv) + common)
        sync(device)
        launches = launch_counts()
        for name, n in launches.items():
            total[name] += n
        require(rc == 0, f"bench {bench}: exit code {rc}")
        recs = store.records(bench)
        require(len(recs) == 1, f"bench {bench} appended {len(recs)} "
                f"records, not 1")
        rec = recs[0]
        fkey = rec["fingerprint_key"]
        require(device != "cuda" or (fkey.startswith("gpu:")
                                     and ":torch" in fkey
                                     and fkey.endswith("W")),
                f"bench {bench}: fingerprint key {fkey!r} is not a card's")
        require(declared(rec["metrics"]), f"bench {bench}: a metric "
                f"without a declared direction: {rec['metrics']}")
        errors, refused = bench_errors(bench, rec["payload"])
        require(not errors, f"bench {bench}: error rows {errors}")
        out[bench] = {"config_hash": rec["config_hash"],
                      "fingerprint_key": fkey, "metrics": rec["metrics"],
                      "seconds": seconds, "refused_rows": len(refused),
                      "launches": {k: v for k, v in launches.items() if v}}
        log(f"bench {bench}: {seconds:.1f} s, {len(rec['metrics'])} "
            f"metrics, launches {out[bench]['launches']}")
        require(not refused, f"bench {bench}: {len(refused)} rows refused "
                f"by a kernel's declared cap: {refused}")
        if bench in BENCH_ROW_KEYS:
            keys = BENCH_ROW_KEYS[bench]
            out[bench]["rows"] = [[r.get(k) for k in keys]
                                  for r in rec["payload"]["records"]]
            log(f"  {bench} rows {keys}: {out[bench]['rows']}")
    for name in ("codebook_lookup", "fused_topk", "fused_topk_codebook",
                 "embedding_bag"):
        require(total[name] > 0, f"{name} never ran on the benches' path")

    # the cache: a second call replays, --force measures again
    module, argv = args[replay_bench]
    rc, replay_s, _ = run_bench(module, list(argv) + common)
    require(rc == 0 and len(store.records(replay_bench)) == 1,
            f"bench {replay_bench}: the cached call appended a record")
    rc, force_s, _ = run_bench(module, list(argv) + common + ["--force"])
    require(rc == 0 and len(store.records(replay_bench)) == 2,
            f"bench {replay_bench}: --force appended no record")
    cache = {"bench": replay_bench, "replay_s": replay_s,
             "force_s": force_s}
    log(f"bench cache: {replay_bench} replayed in {replay_s:.2f} s (no "
        f"record), --force measured again in {force_s:.1f} s")

    # the serving roofline of the newest kernel record
    rc, _, _ = run_bench("roofline", common + ["--serving", "store",
                                               "--json"])
    (roof,) = store.records("roofline_serving")
    require(rc == 0 and declared(roof["metrics"]),
            "roofline: no record with declared metrics")
    roof_rows = [{k: r.get(k) for k in (
        "variant", "B", "N", "d", "K", "us_per_call", "bound_us",
        "bound_by", "hbm_frac", "roofline_frac")}
        for r in roof["payload"]["rows"] if "us_per_call" in r]
    for r in roof_rows:
        log(f"  roofline {r['variant']:14s} B={r['B']:4d} N={r['N']:6d} "
            f"{r['us_per_call']:9.2f} us, bound {r['bound_us']:.3f} us "
            f"({r['bound_by']}), {100 * r['roofline_frac']:.1f}% of it")

    # one traced and profiled run of the train bench
    trace_out = os.path.join(workdir, "traces", "train_pipeline.jsonl")
    prof_dir = os.path.join(workdir, "profiles")
    prev = get_tracer()
    set_tracer(Tracer(enabled=False))
    try:
        rc, prof_s, _ = run_bench("train_bench", list(
            profile_args or PROFILE_ARGS) + [
            "--device", device, "--no-store", "--trace", "--trace-out",
            trace_out, "--profile", "--profile-dir", prof_dir])
    finally:
        set_tracer(prev)
    require(rc == 0, f"the profiled train bench: exit code {rc}")
    trace_json = os.path.join(prof_dir, "train_pipeline", "trainer_sweep",
                              "trace.json")
    require(os.path.getsize(trace_json) > 0, "the profile's trace is empty")
    with open(trace_json) as f:
        events = json.load(f)["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            name = e.get("name", "")[:90]
            kernels[name] = kernels.get(name, 0) + 1
    ranges = {e.get("name") for e in events
              if e.get("cat") == "user_annotation"}
    if device == "cuda":
        for name in ("codebook_lookup_kernel", "csr_gather_sum_kernel"):
            require(any(name in k for k in kernels), f"the profile's device "
                    f"events hold no {name}: {sorted(kernels)[:20]}")
        require({"fit_gamma", "cluster_solve"} <= ranges,
                f"the profile holds no fit_gamma/cluster_solve range "
                f"(record_function bridge): {sorted(ranges)[:20]}")
    spans = read_trace(trace_out)["spans"]
    roll = rollup(spans)
    require({"fit_gamma", "cluster_solve"} <= set(roll),
            f"the obs rollup lacks fit_gamma/cluster_solve: {sorted(roll)}")
    by_id = {sp["span"]: sp for sp in spans}
    nested = [sp for sp in spans if sp["name"] == "cluster_solve"
              and by_id.get(sp["parent"], {}).get("name") == "fit_gamma"]
    require(nested, "no cluster_solve span under fit_gamma")
    for line in obs_report(trace_out, rollup_only=True).splitlines():
        log(f"  obs {line}")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    profile = {"seconds": prof_s, "trace_bytes": os.path.getsize(trace_json),
               "device_events": sum(1 for e in events if e.get("cat") in
                                    ("kernel", "gpu_memcpy", "gpu_memset")),
               "kernel_launches_by_name": dict(top),
               "spans": len(spans), "cluster_solve_under_fit_gamma":
               len(nested), "rollup": {k: roll[k] for k in (
                   "fit_gamma", "cluster_solve", "lp_sweep") if k in roll}}
    log(f"profiled train bench: {prof_s:.1f} s, {profile['device_events']} "
        f"device events in {profile['trace_bytes']} bytes; {len(spans)} "
        f"spans, {len(nested)} cluster_solve under fit_gamma")

    # the gate on the store
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_summary.main(["--check", "--store", store_dir])
    require(rc == 0, f"bench_summary --check: exit code {rc}")
    verdicts = buf.getvalue().splitlines()
    for line in verdicts:
        log(f"  gate {line}")
    for bench in store.benches():
        for r in store.records(bench):
            require(declared(r["metrics"]), f"{bench}: a stored metric "
                    f"without a declared direction")
    log(f"benches phase: {time.perf_counter() - t_phase:.1f} s")
    return {"benches": out, "cache": cache, "roofline": roof_rows,
            "profile": profile, "gate": verdicts,
            "seconds": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# the paper's experiments (repro_torch.launch.paper)
# ---------------------------------------------------------------------------
# the modules the smoke runs; Figures 1 and 3 and Tables 5, 9 and 11 run
# on the card through tools/paper_full.py
PAPER_MODULES = ("fig2_efficiency", "fig4_convergence", "table4_recall",
                 "table6_scu")
PAPER_COMPRESSION = 0.25


def parse_row(row: dict) -> dict:
    """A suite row's derived ``k=v;...`` as numbers where they parse."""
    out = {}
    for kv in filter(None, row["derived"].split(";")):
        k, v = kv.split("=", 1)
        try:
            out[k] = float(v)
        except ValueError:
            out[k] = v
    return out


def finite_row(row: dict) -> bool:
    """Every number of a suite row finite."""
    nums = [v for v in parse_row(row).values() if isinstance(v, float)]
    return all(math.isfinite(v) for v in nums + [row["us_per_call"]])


def paper_path(workdir: str, device: str = "cuda") -> dict:
    """The paper suite (``python -m repro_torch.launch.paper.run --fast``)
    on ``PAPER_MODULES`` as a user calls it, in this process through
    ``main(argv, modules=...)``, into a fresh store under ``workdir``:
    exit 0 and no module ``FAILED``; one record a module with this card's
    fingerprint and every metric's direction declared; every row's
    numbers finite (``finite_row``); codebook_lookup and the CSR
    gather-sum launched over the suite (counts zeroed just before, read
    just after); table4's ``baco`` at most ``PAPER_COMPRESSION`` of
    ``full``'s params. Then fig2's ``bench(fast=False)`` (``SIZES_FULL``,
    the grid search on the 84k-node graph): the three grid modes must
    select one gamma. Then fig4's label count at each iteration (on its
    fast dataset, gowalla_s) must equal the CPU port's."""
    from repro_torch.launch.paper import fig2_efficiency, fig4_convergence
    from repro_torch.launch.paper import run as suite
    from repro_torch.results import ResultsStore

    t_phase = time.perf_counter()
    store_dir = os.path.join(workdir, "paper_store")
    zero_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = suite.main(["--fast", "--device", device, "--store",
                         store_dir], modules=list(PAPER_MODULES))
    sync(device)
    launches = {k: v for k, v in launch_counts().items() if v}
    text = buf.getvalue()
    for line in text.splitlines():
        if line.startswith("#"):
            log(f"  paper {line[2:]}")
    require(rc == 0 and "FAILED" not in text,
            f"the paper suite: exit code {rc}; "
            f"{[ln for ln in text.splitlines() if 'FAILED' in ln]}")
    recs = ResultsStore(store_dir).records("suite")
    by_module = {r["payload"]["module"]: r for r in recs}
    require(len(recs) == len(PAPER_MODULES)
            and set(by_module) == set(PAPER_MODULES),
            f"the paper suite recorded {sorted(by_module)} in {len(recs)} "
            f"records, not one a module of {list(PAPER_MODULES)}")
    walls = {}
    for name, rec in by_module.items():
        fkey = rec["fingerprint_key"]
        require(device != "cuda" or (fkey.startswith("gpu:")
                                     and fkey.endswith("W")),
                f"paper {name}: fingerprint key {fkey!r} is not a card's")
        require(declared(rec["metrics"]), f"paper {name}: a metric "
                f"without a declared direction: {rec['metrics']}")
        bad = [r["name"] for r in rec["payload"]["rows"]
               if not finite_row(r)]
        require(not bad, f"paper {name}: rows with a non-finite number: "
                f"{bad}")
        walls[name] = rec["metrics"]["wall_s"]["value"]
    for name in ("codebook_lookup", "embedding_bag"):
        require(launches.get(name, 0) > 0,
                f"{name} never ran on the paper suite's path")
    out = {"wall_s": walls, "launches": launches,
           "launches_weighted": counted_kernels()[
               "embedding_bag"].launches_weighted}

    def rows_of(module):
        return {r["name"].split("/")[-1]: {"us_per_call": r["us_per_call"],
                                           **parse_row(r)}
                for r in by_module[module]["payload"]["rows"]}

    t4 = {m: {k: r[k] for k in ("recall20", "ndcg20", "params") if k in r}
          for m, r in rows_of("table4_recall").items()}
    require(t4["baco"]["params"] <= PAPER_COMPRESSION * t4["full"]["params"],
            f"table4: baco's {t4['baco']['params']} params exceed "
            f"{PAPER_COMPRESSION} x full's {t4['full']['params']}")
    out["table4"] = t4
    log(f"  table4 (recall20, ndcg20, params): "
        f"{ {m: tuple(r.values()) for m, r in t4.items()} }")
    out["fig2_build_s"] = {m: r["us_per_call"] / 1e6
                           for m, r in rows_of("fig2_efficiency").items()}

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        records = fig2_efficiency.bench(fast=False, device=device)
    grid = [r for r in records if r["kind"] == "grid_search"]
    gammas = {r["gamma"] for r in grid}
    require(len(grid) == 3 and len(gammas) == 1,
            f"fig2 at full size: the grid modes select {gammas}")
    out["fig2_full"] = {"seconds": time.perf_counter() - t0,
                        "records": records}
    for r in records:
        log(f"  fig2 full {r}")

    k_card = [int(r["k"]) for r in rows_of("fig4_convergence").values()]
    (ds,) = fig4_convergence.datasets(fast=True)
    _, _, _, train, _ = fig4_convergence.get_dataset(ds)
    k_cpu = [k for _, _, k in fig4_convergence.label_counts(train, "cpu")]
    require(k_card == k_cpu, f"fig4 on {ds}: the card's label counts "
            f"{k_card} differ from the CPU's {k_cpu}")
    out["fig4_k"] = k_card
    out["seconds"] = time.perf_counter() - t_phase
    log(f"paper phase: {out['seconds']:.1f} s; modules {walls}; "
        f"launches {launches}")
    return out


# ---------------------------------------------------------------------------
# where a request's device time goes (torch.profiler, fused scorer, B=64)
# ---------------------------------------------------------------------------
def device_times(prof, n: int) -> dict:
    """ms of device time per unit (request, step) by kernel name, from a
    ``torch.profiler`` run over ``n`` units. Only kernels count: the
    ranges of the autograd functions (``_Propagate``, ``_CodebookSum``),
    which the profiler also gives device time, would count their
    kernels twice."""
    from torch.autograd import DeviceType
    per_kernel = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if (t > 0 and e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and not e.key.startswith(("aten::", "cuda"))):
            per_kernel[e.key[:70]] = t / 1e3 / n
    return per_kernel


def profile_chunk(trainer, n: int) -> dict:
    """One fused chunk of ``n`` training steps under ``torch.profiler``:
    device time per step by kernel, wall time per step, idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.backend.chunk(trainer, n).tolist()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = device_times(prof, n)
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    log(f"profile (training, {n} fused steps): device busy {busy:.3f} ms of "
        f"{wall_ms / n:.3f} ms a step")
    for name, ms in top:
        log(f"  {ms:8.4f} ms  {100 * ms / busy:5.1f}%  {name}")
    return {"steps": n, "device_ms_per_step": busy,
            "wall_ms_per_step": wall_ms / n,
            "idle_share": 1.0 - busy / (wall_ms / n),
            "top_kernels_ms": dict(top)}


def profile_requests(run: dict, batch: int = 64, n: int = 5) -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import RecsysSession

    session = RecsysSession.from_artifact(run["loaded"], k=20,
                                          scorer="fused", device="cuda")
    ids = np.arange(batch)
    session(ids)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()          # the requests, not profiler set-up
        for _ in range(n):
            session(ids)                  # each ends in a synchronize
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = device_times(prof, n)                 # ms per request
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    out = {"batch": batch, "requests": n,
           "device_ms_per_request": busy,
           "wall_ms_per_request": wall_ms / n,
           "idle_share": 1.0 - busy / (wall_ms / n),
           "top_kernels_ms": dict(top)}
    log(f"profile (fused, B={batch}, {n} requests): device busy "
        f"{busy:.3f} ms of {wall_ms / n:.3f} ms per request")
    for name, ms in top:
        log(f"  {ms:8.3f} ms  {100 * ms / busy:5.1f}%  {name}")
    return out


# ---------------------------------------------------------------------------
# phase 6: small input, GPU against the port's own CPU (plain) path
# ---------------------------------------------------------------------------
def small_reference() -> None:
    import numpy as np

    import torch

    from repro_torch.core import ClusterEngine
    from repro_torch.data import paperlike_dataset
    from repro_torch.embedding import dequantize_params
    from repro_torch.models import lightgcn as L
    from repro_torch.models.lightgcn import (edge_norms, from_sketch,
                                             init_params)
    from repro_torch.serve import CompressedArtifact
    from repro_torch.training import TrainConfig, Trainer

    _, _, _, train, _ = paperlike_dataset("gowalla_s", seed=0)
    sk = {dev: ClusterEngine(device=dev).build(train, d=64, ratio=0.25)
          for dev in ("cuda", "cpu")}
    require(np.array_equal(sk["cuda"].user_idx, sk["cpu"].user_idx)
            and np.array_equal(sk["cuda"].item_idx, sk["cpu"].item_idx)
            and sk["cuda"].meta["gamma"] == sk["cpu"].meta["gamma"],
            "GPU and CPU sketches differ on gowalla_s")
    mcfg = from_sketch(train, sk["cuda"], dim=64)
    art = CompressedArtifact.from_parts(
        init_params(1, mcfg), {"edge_u": train.edge_u,
                               "edge_v": train.edge_v,
                               "edge_norm": edge_norms(train)},
        sk["cuda"], mcfg)
    ids = np.arange(0, train.n_users, 7)
    sess = {dev: art.session(k=20, scorer="fused", device=dev)
            for dev in ("cuda", "cpu")}
    out = {dev: sess[dev](ids) for dev in sess}
    gpu = sess["cuda"]
    u, v = L.eval_embeddings(dequantize_params(gpu.params), gpu.statics,
                             gpu.mcfg, torch.as_tensor(ids, device="cuda"))
    n_diff = topk_agree(out["cuda"][0].cpu(), out["cuda"][1].cpu(),
                        out["cpu"][0], out["cpu"][1],
                        pair_scorer(u, v, mask=gpu.statics.get("item_mask")))
    log(f"gowalla_s: GPU sketch == CPU sketch (K_u={sk['cuda'].k_users}, "
        f"K_v={sk['cuda'].k_items}); GPU fused top-k == CPU top-k for "
        f"{ids.size} users ({n_diff} ids differ at near-ties)")
    # 20 training steps on the GPU and on the port's CPU path: the same
    # numpy batches and init; losses agree to rtol 1e-5 (reductions such
    # as the batch mean add in another order on the two devices)
    cfg = TrainConfig(steps=20, batch_size=2048, lr=5e-3, seed=0,
                      backend="host", sampler="numpy")
    losses = {dev: Trainer(train, sk["cuda"], cfg, device=dev).run(
        log_every=0) for dev in ("cuda", "cpu")}
    require(np.allclose(losses["cuda"], losses["cpu"], rtol=1e-5, atol=0),
            f"GPU and CPU training losses differ: {losses}")
    log(f"gowalla_s: 20 training steps, GPU losses == CPU losses to rtol "
        f"1e-5 (last {losses['cuda'][-1]:.6f} / {losses['cpu'][-1]:.6f})")


def main() -> int:
    try:
        import torch
    except ImportError:
        log("FAIL: torch is not installed")
        return 1
    if not torch.cuda.is_available():
        log("FAIL: no CUDA device (torch.cuda.is_available() is False)")
        return 1
    try:
        import repro_torch  # noqa: F401
        from repro_torch.kernels import platform
    except ImportError as e:
        log(f"FAIL: the port is not importable from {ROOT}/src: {e}")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        smi = gpu_line()
        log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
            f"{torch.cuda.get_device_name(0)}")
        t0 = time.perf_counter()
        report = platform.build()
        log(f"kernel build: {time.perf_counter() - t0:.1f} s "
            f"({ {k: round(v['seconds'], 1) for k, v in report.items()} })")
        for name, r in report.items():
            for line in r["log"].splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {name}: {line.strip()}")
        with tempfile.TemporaryDirectory(dir=os.path.join(
                ROOT, "build")) as workdir:
            run = main_path(workdir)
            run["sharded"] = sharded_path(run)
            run["stream"] = stream_path()
            run["frontdoor"] = frontdoor_path(run)
            run["scale"] = scale_path()
            run["baselines"] = baselines_path(run, workdir)
            run["arch"] = arch_path()
            run["lm"] = lm_path()
            run["lm_mesh"] = lm_mesh_path()
            run["arch_mesh"] = arch_mesh_path()
            run["dryrun"] = dryrun_path()
            run["op_analysis"] = op_analysis_path()
            run["gnn"] = gnn_path()
            emb_run = embedding_path(run)
            bench_run = bench_path()
            floor = timer_floor_ms()
            log(f"kernel timer floor (one-element add): {floor:.5f} ms")
            kernels = [check_codebook_lookup(run), check_fused_topk(run),
                       check_fused_topk_codebook(run, emb_run),
                       check_embedding_bag(run, emb_run),
                       check_embedding_bag16(run),
                       check_dot_interaction(bench_run, run),
                       check_flash_attention(bench_run, run)]
            prof = profile_requests(run)
        small_reference()
        with tempfile.TemporaryDirectory(dir=os.path.join(
                ROOT, "build")) as bench_dir:
            benches = benches_path(bench_dir)
        with tempfile.TemporaryDirectory(dir=os.path.join(
                ROOT, "build")) as paper_dir:
            paper = paper_path(paper_dir)
    except (SmokeFailure, RuntimeError, ValueError, AssertionError,
            subprocess.CalledProcessError) as e:
        log(f"FAIL: {type(e).__name__}: {e}")
        return 1
    print(json.dumps({"sharded": run["sharded"]}))
    print(json.dumps({"stream": run["stream"]}))
    print(json.dumps({"frontdoor": run["frontdoor"]}))
    print(json.dumps({"scale": run["scale"]}))
    print(json.dumps({"baselines": run["baselines"]}))
    print(json.dumps({"arch": run["arch"]}))
    print(json.dumps({"lm": run["lm"]}))
    print(json.dumps({"lm_mesh": run["lm_mesh"]}))
    print(json.dumps({"arch_mesh": run["arch_mesh"]}))
    print(json.dumps({"dryrun": run["dryrun"]}))
    print(json.dumps({"op_analysis": run["op_analysis"]}))
    print(json.dumps({"gnn": run["gnn"]}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"timer": {"floor_ms": floor,
                                "spin_cycles": spin_cycles()}}))
    tr = run["training"]
    print(json.dumps({"main_path": {
        "cluster_s": run["cluster_s"], "cluster": run["cluster"],
        "solver_stats": run["stats"], "serve": run["serve"],
        "profile": prof,
        "training": {k: tr[k] for k in (
            "steps", "ms_per_step", "ms_per_step_chunks", "seconds",
            "loss_first", "loss_last", "untrained", "trained",
            "recall_ratio", "launches", "weighted_per_step",
            "profile")}}}))
    print(json.dumps({"embedding_path": {
        "seconds": emb_run["seconds"], "launches": emb_run["launches"],
        "readout_cases": emb_run["readout_cases"],
        "near_tie_ids": emb_run["near_tie_ids"]}}))
    print(json.dumps({"kernel_bench": bench_run}))
    print(json.dumps(benches))
    print(json.dumps({"paper": paper}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
