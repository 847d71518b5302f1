#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device: a CUDA card of capability (9, 0); prints the card's name and
   power limit, builds the hand-written kernels from ``src/repro_torch/csrc``
   (one nvcc per source, all at once) and prints the build time and the
   ptxas register/spill report.
2. Kernels against their plain PyTorch versions, on the card:
   * B1 and B2 (with B3, the fix-up, fused into its tail: one launch per
     Stream-K region), the full sweep at M=64, N=4096, K=4096 (and two small
     ragged shapes, one per staging path; with bf16 activations B1's and
     B2's sub-blocks run the tensor-core mainloop of ``csrc/mma_bf16.cuh``,
     with int8 ones that of ``csrc/mma_s8.cuh``): all
     8 policies x 2 grid sizes x {bf16 (2e-2), f32 (1e-4)} x epilogues
     {none, mul_silu, bias+gelu, square}; the split tiles' contributor slots against
     the plain sweep, the Stream-K region's C against the plain sweep then
     the plain fix-up, B1's C against its plain version, the composed C
     against the f32-accumulated ``gemm_ref``;
   * the plain projection shapes of granite-8b and olmoe-1b-7b (attention,
     MLP, router in f32, lm_head), M in {1, 4, 64} and each served prompt
     length, and those of phase 6's and phase 7's eight models (``arch_nk``)
     at M in {4, 64} (whisper's also at 1500, its frames), under the H100
     selector's pick, DP and ALL_SK, against
     ``gemm_ref``; the Stream-K region bitwise identical across two runs;
   * B5, the grouped kernel, at olmoe-1b-7b's expert shapes (64 experts x
     4 or 16 rows, 2048 -> 1024 and 1024 -> 2048) and a small unaligned one:
     every policy x g in {66, 132, 264} x {bf16, f32} x epilogues {none,
     gelu, bias, mul_silu, square} x group sizes {full, ragged with empty
     groups}
     against its plain version and per-group ``gemm_ref``; all-empty sizes
     launch nothing; the Stream-K form with split tiles is bitwise
     deterministic (bf16 activations run the tensor-core mainloop of
     ``csrc/mma_bf16.cuh``, int8 ones that of ``csrc/mma_s8.cuh``, f32 ones
     the f32 FMA mainloop of ``csrc/fma_f32.cuh``);
   * each kernel timed with CUDA events at a decode shape it serves (device
     time of calls queued to run back to back, and the time of calls as the
     host issues them; see ``time_ms``), beside its plain version, one
     library call computing the same function (``torch.matmul`` for B1 and
     for the Stream-K region, which computes the whole GEMM under ALL_SK;
     ``torch.bmm`` for B5) and its
     bound (bytes over 3.35 TB/s or operations over 989 TFLOP/s, whichever
     is larger);
   * the quantization ladder (int8 and packed int4 weights with their
     per-output-channel scales; int8 activations with per-row scales and an
     int32 MAC): B1 and the Stream-K region through ``ops.gemm`` and each on
     its own, and both B5
     forms, on each of the six operand pairs (f32 or bf16 x int8, int8 x
     int8, f32 or bf16 or int8 x int4), every policy x g in {66, 132, 264} x the
     epilogues (``square`` among them), at the sweep shapes plus an odd K and at the grouped shapes
     (ragged sizes, odd K), against the plain versions and
     dequantize-then-matmul; the Stream-K forms bitwise deterministic; then
     each served rung's kernels timed at the decode (M = 4) and prompt
     (M = 57) shapes, beside the plain version, the bound at the int8/int4
     widths of B, and a yardstick (``torch._int_mm`` for int8 x int8, its M
     padded to a size it takes; else ``torch.matmul``/``torch.bmm`` on the
     dequantized bf16 weight, a dense yardstick); int8 x int4 is timed the
     same way (rung ``int4-dynamic``, which no serve rung reaches); B5's
     bf16-activation rungs (bf16, bf16 x int8, bf16 x int4) in both forms are
     then printed as one table beside the times of the SIMT mainloop they
     replaced (``B5_SIMT_MS``), the bound and ``torch.bmm``, and so are its
     int8-activation rungs (int8-dynamic and int4-dynamic, now on the s8
     tensor-core mainloop of ``csrc/mma_s8.cuh``, beside ``B5_S8_SIMT_MS``),
     and B1 and the B2+B3 composition at their decode shapes, on the
     bf16-activation rungs (``B12_SIMT_MS``) and on the int8-activation ones
     (now on ``csrc/mma_s8.cuh``, beside ``B12_S8_SIMT_MS``), beside the
     library call; and B1, B2+B3 and both B5 forms on f32 activations, with
     f32, int8 and packed int4 weights (the f32 FMA mainloop of
     ``csrc/fma_f32.cuh``) beside
     ``torch.matmul``/``torch.bmm`` in f32, B1's and B2's calls also held
     against their plain versions (``F32_TABLE``, ``F32_PAIRS``);
   * B6, the split-K baseline, on every operand pair (f32, bf16 and the six
     quantized ones; bf16 activations run ``csrc/mma_bf16.cuh``'s
     tensor-core mainloop, int8 ones ``csrc/mma_s8.cuh``'s, f32 ones the
     f32 FMA mainloop of ``csrc/fma_f32.cuh``) x s in {1, 2, 4, 8} x g in
     {0, 66, 132, 264} at the sweep shape, a ragged unaligned one, an odd K
     and K < bk * s: its partials against ``splitk_partials_plain`` (empty
     splits read 0),
     ``splitk.ops.gemm`` against ``gemm_ref`` or dequantize-then-matmul, two
     runs bitwise identical, and a planted fault (the reduction drops the
     last split) that must read at least 3 times its limit; each pair's
     launches counted;
   * the slice's main path, the baseline comparison: at granite-8b's five
     projection shapes, M = 4 and 57, bf16, the H100 pick (the whole
     composition), ``dp.ops.gemm`` and ``splitk.ops.gemm`` at s in
     {2, 4, 8} with the pick's tile, each once against ``gemm_ref`` with the
     launch counters zeroed just before and read just after (every B6 call
     must have launched), then each timed beside ``torch.matmul``; B6 timed
     alone at 4x14336x4096, s = 4, on all eight pairs (``time_splitk``:
     first held against its plain version, int8 activations bitwise),
     beside the plain version, the library call of the whole GEMM and the
     bound; its bf16 row goes to the ``kernels`` line;
   * ``gemm_batched`` through the ``cuda`` backend at B = 4, granite-8b's
     4096 -> 14336 at M = 4, f32, against ``torch.bmm``: B times the pick's
     launches.
3. Serve, through ``ServeEngine`` on the ``cuda`` backend, 4 slots, max_seq
   256, 4 seeded requests of 16-64 tokens, 8 new tokens each, with seeded
   random weights: granite-8b at full width (36 layers, d_model 4096, bf16,
   ~16.5 GB), then, its weights freed, olmoe-1b-7b at full width (16 layers,
   d_model 2048, 64 experts top-8, bf16, ~13.8 GB); each dense, then on each
   rung (``int8``, ``int8-dynamic``, ``int4``), quantized from the same bf16
   weights, each quantized tree freed before the next. For each run, the
   launch counters are zeroed just before it and read just after; every
   kernel (and rung) the selections call for must have launched, every
   quantized projection must have run on its rung, and each fused grouped
   dispatch must be exactly one B5 launch (48 per olmoe decode step). The
   first request's prefill logits are held against the ``torch`` backend on
   the same weights (for olmoe the routing choices the two backends made
   differently are counted; its dense run holds the reading with the
   ``torch`` backend replaying the ``cuda`` run's top-8 choices, and the
   router GEMM on its own, see below), and so are the logits of a planted
   fault, read the same way, which must read at least 3 times that limit:
   granite's DP GEMMs, or olmoe's grouped GEMMs, with their last K chunk
   dropped. A quantized
   run's logits are also compared with the dense run's (quantization error,
   reported, not limited). A warm decode step is then broken down (wall
   time, host enqueue time, device busy time from ``torch.profiler``) under
   the ``cuda`` backend and, as the yardstick, the ``torch`` backend.
   Between the two models, granite-8b at full width and 2 layers with the
   int8 KV cache (``kv_cache_dtype="int8"``): served on the ``cuda`` backend
   with its launch counts read as above, then the decode logits of the
   first prompt (prefill and two decode steps) held against the ``torch``
   backend under granite's ``LOGITS_TOL`` and compared with the
   model-dtype cache (reported).
4. Tune (``phase_tune``): online adaptation on the card. granite-8b at full
   width serves the same four requests through a cold selector (nominal
   H100, Hopper tiles, an empty database and sieve) whose
   ``AdaptiveTuner`` (``hot_threshold=1``, one round a decode step, top-5
   budget) times each missed fingerprint on the hand-written kernels with
   ``measure_wallclock`` and journals it to a temporary directory; then
   olmoe-1b-7b at full width and ``TUNE_OLMOE_LAYERS`` layers, for the
   fused grouped fingerprints. The journal is replayed into a fresh
   database (its snapshot round trip must give equal records), calibrated
   (the bf16 profile must fit on at least ``MIN_RECORDS`` records; the
   baseline comparison's shapes are tuned besides when the served ones
   give fewer), and sieved (true-negative rate 1.0). granite-8b is served
   again from that warm ``SelectorState``, launch counters zeroed just
   before and read just after: every dispatch must be a database hit, every
   kernel its picks call for must launch, and its prefill logits hold
   ``LOGITS_TOL`` against the ``torch`` backend. Reported: the phase's
   seconds, measurements and records, the winners by policy and g, the
   sieve's elimination rate over the tuned keys, the fitted terms beside
   the nominal ones, each winner's model rank under the nominal machine
   and under the calibration, and a warm decode step's GEMM ms with the
   tuned picks beside the nominal model's (``kernel_ab.py --tuned`` times
   each decode projection's two picks on their own). The tuner's times
   keep the weights in L2 and are issued by the host back to back (the
   paper's protocol), unlike phase 2's.
5. Paged serving and the fleet (``phase_paged``), on the ``cuda`` backend,
   page size 16, the equal-memory pool of 64 pages, 4 active, max_seq 256:
   (a) granite-8b at full width on phase 3's bf16 weights (run at the end
   of its phase 3, before they are freed): the four prompts through
   ``PagedServeEngine`` with whole-prompt prefill and with chunks of 16,
   launch counters zeroed just before each run and read just after (B1 and
   B2 must launch, and every kernel the selections call for), the greedy
   tokens set beside phase 3's dense run (reported); one paged decode step
   held against the dense engine's step on the same prefilled requests, and
   the chunked prefill's last-chunk logits against the whole prompt's, both
   at ``LOGITS_TOL``, with a planted fault each that must read at least 3
   times the limit (request 0's first page-table entry pointing at request
   1's first page; the last chunk attending over a zeroed prefix); the
   dense step with its cache cut to the paged view's rows read against both
   steps (reported: whether they differ only by the attention's length);
   the gather of a decode step's largest view timed on its own. (b) olmoe-1b-7b
   at full width and ``PAGED_OLMOE_LAYERS`` layers, paged with chunks of 16:
   one B5 launch per fused grouped dispatch, the chunked logits against the
   ``torch`` backend replaying the run's top-8 choices chunk by chunk at
   olmoe's ``LOGITS_TOL``, the router at ``ROUTER_TOL``, and the same
   planted fault. (c) The serve CLI (``repro_torch.launch.serve.main``) at
   full width: granite-8b, ``--paged --prefill-chunk 16 --replay poisson
   --requests 8 --workers 2 --adapt --adapt-every 1 --top-k 5
   --gossip-every 2`` into a temporary journal (worker 1's gossip must
   absorb entries), then the same command with ``--merge-journals`` and
   without ``--adapt`` (every decode dispatch must be a database hit); both
   exit 0 with every request completed, B1 and B2 launched. Reported: the
   phase's seconds, wall ms per decode step paged beside dense, peak pages
   and residents, admission counters, the step SLO percentiles, gossip
   rounds and entries, and the fleet's merged records and conflicts.
6. Four more configs (``phase_archs``), dense bf16 on the ``cuda`` backend
   through ``serve_run`` as in phase 3 (4 slots, max_seq 256, the four
   seeded prompts x 8 tokens, seeded random weights, the selector's
   cost-model path), one model on the card at a time, each freed before
   the next: nemotron-4-15b at full width (32 layers, squared-ReLU MLP on
   the ``square`` epilogue), gemma3-27b at full width cut to 30 of its 62
   layers (5:1 local:global windows of 1024, the tied head, d_head 168),
   and mistral-large-123b and qwen3-moe-235b-a22b at full width cut to 2
   layers (``ARCH_CELLS``: 245 and 463 GB of weights do not fit one card).
   Each: the instantiated parameter count equal to ``cfg.param_count()``,
   the launch checks of phase 3, greedy tokens in range, the first
   prompt's logits against the ``torch`` backend within ``LOGITS_TOL``
   (qwen3-moe with the ``cuda`` run's top-8 choices replayed and its router
   at ``ROUTER_TOL``; B5 at G = 128), a planted fault that must read at
   least 3 times the limit (the dense models: every GEMM with a DP region
   drops its last K chunk, since their prefill picks hybrids; qwen3-moe:
   every grouped GEMM), the decode breakdown beside the weight-read floor,
   and the peak memory. gemma3 also: its tied head's GEMM timed at the
   decode shape, built once (a warm decode step must not allocate a copy of
   it), and one long request (``long_request_check``): a 1100-token prompt
   past the window, max_seq 1152, its prefill logits against the ``torch``
   backend, 8 greedy decode steps on the uniform cache beside the same
   steps on the ring path (``windowed_cache_from_uniform``, then
   ``decode_step_windowed`` fed the uniform path's tokens) within
   ``LOGITS_TOL`` a step, and the planted fault of every layer made global.
7. The other families (``phase_families``), dense bf16 on the ``cuda``
   backend, seeded random weights, the selector's cost-model path, each at
   full width and full depth but llava-next-34b, cut to 10 of its 60 layers
   (``FAMILY_CELLS``), one model on the card at a time (llava-next-34b
   last): mamba2-1.3b
   (the SSD block, its tied head N = 50280), zamba2-1.2b (Mamba2 layers and
   the shared attention and MLP block at every 6th layer) and
   llava-next-34b through ``serve_run`` as in phase 6, with the planted
   fault on every GEMM with a DP region; whisper-large-v3 through
   ``whisper_run``: four requests of 1500 seeded frame embeddings and an
   8-token decoder prompt, ``EncDec.prefill`` as one batch, then 8 greedy
   decode steps, the prefill's and every step's logits against the
   ``torch`` backend fed the same tokens within ``LOGITS_TOL``, the same
   planted fault on the prefill, and the decode breakdown beside the floor.
   Each: the instantiated count equal to ``cfg.param_count()``, B1 and B2
   launched and B5 not, the peak memory; the tied heads timed at the
   decode shape (``tied_head_check``; whisper's rows are not 16-byte
   aligned). mamba2 also: 8 requests through 4 slots give each request the
   tokens of the same prompt served alone in a fresh engine
   (``slot_reuse_check``). llava also: one image request
   (``image_request_check``), 576 seeded patch embeddings before the first
   prompt's text, max_seq 704, its prefill's and 8 decode steps' logits
   against the ``torch`` backend fed the same tokens, and the planted fault
   of the patches dropped.
8. Training (``phase_train``), one model on the card at a time: granite-8b
   and olmoe-1b-7b at full width, their depth cut to 4 of 36 and 2 of 16
   layers (``TRAIN_CELLS``; their params, gradients and AdamW state, 16
   bytes a parameter, do not fit one card at full depth), dense bf16,
   seeded weights, the selector's cost-model path, ``SyntheticLMData(seed
   0)`` at batch 1 x ``TRAIN_SEQ`` 4096 tokens, per-layer remat, AdamW on
   ``warmup_cosine(3e-4, 2, steps)``. Each: the instantiated count equal to
   ``cfg.param_count()``; one step's loss and gradients through the
   kernels (forward on the hand-written kernels, backward from
   ``GemmGrad``) against autograd through the ``torch`` backend (the loss
   within ``TRAIN_LOSS_TOL``, the whole gradient tree within
   ``TRAIN_GRAD_TOL`` in relative L2, every leaf with a gradient, the
   worst leaf reported; olmoe with the ``torch`` backend replaying the
   ``cuda`` run's top-8 choices layer by layer, its own routing reported),
   and a planted fault, the ``mul_silu`` VJP without the gate's term, that
   must read at least 3 times the limit; the step's launches, forward,
   remat recompute and ``GemmGrad``'s accumulator recompute; each forward
   GEMM at its training shape and pick against the ``torch`` backend's
   formula, timed beside ``torch.matmul`` and its bound, and the backward's
   two f32 products timed at the same shapes (``train_gemm_check``); then
   the slice's main path, ``Trainer.fit`` for ``TRAIN_STEPS`` on one
   repeated batch with the launch counters zeroed just before and read just
   after (granite: B1 and/or B2 and no B5; olmoe: B5, and the kernels the
   f32 router's pick calls for), its losses finite and falling; one more step split by CUDA events
   (forward, backward, optimizer) and traced (the GEMM kernels' device ms,
   the library GEMMs', the rest), 6NT over the step time at 989 TFLOP/s,
   the peak memory; then ``STREAM_STEPS`` of the stream uninterrupted, and the same run
   checkpointed every 2 steps (``CheckpointManager`` in a
   temporary directory of the checkout) with a failure injected after step
   2, and a fresh ``Trainer`` resuming from that checkpoint: the restored
   state bit for bit the saved one, its steps 3 and 4 within
   ``RESUME_TOL`` of the uninterrupted run (whether bitwise, reported).
9. Sharding plans and the dry run (``phase_shard``). (a) Started with the
   build in a child process that never touches the card (``start_dryrun``):
   ``repro_torch.launch.dryrun.lower_cell`` traces granite-8b and
   olmoe-1b-7b at full width and depth on every applicable shape cell on
   both production meshes ((16, 16) and (2, 16, 16)), and the other eight
   configs at ``decode_32k`` on (16, 16), on the meta device under the H100
   selector; every cell must reach ``ok``, every plain GEMM's local M be
   the global M over the cell's ``div["batch"]`` and its N or K over
   ``div["model"]`` (the grouped ones: experts over ``div["model"]``), and
   the FLOP counter's share of the dispatch equal 2 G M N K over the log;
   each cell's unique GEMMs, per-device argument GB, FLOPs and seconds are
   logged. (b) Every unique per-shard GEMM of granite-8b and olmoe-1b-7b at
   ``train_4k``, ``prefill_32k`` and ``decode_32k`` (single pod) on seeded
   operands at its local shape, launched once on the ``cuda`` backend with
   the recorded policy, tile and g and held against the ``torch`` backend
   (2e-2 bf16, 1e-4 the f32 router), the launch counters zeroed just before
   and read just after, then timed beside ``torch.matmul`` and the bound.
   (c) Inside phase 3, on its olmoe-1b-7b weights: the model served through
   ``ServeEngine`` on ``moe_impl="sharded"`` (``div`` batch 4: the 4 slots
   route as 4 token groups) and on ``moe_impl="hinted"``, launch counts
   read as in phase 3, and a (4, 35) prefill batch of the four prompts held
   against the ``torch`` backend of the same variant replaying the ``cuda``
   run's top-8 choices at olmoe's ``LOGITS_TOL``, each layer's router GEMM
   against ``torch.matmul`` at ``ROUTER_TOL`` (the own-routing reading
   reported). (d) The serve CLI at full width, granite-8b, without a plan
   and with ``--mesh-model 1``: the same greedy tokens. Every check of the
   phase has a planted fault (a divisor or a log entry off; each GEMM, the
   variants' grouped GEMMs and the router with their last K chunk dropped;
   a changed token) that must be caught, the numeric ones at 3x or more.
10. Across ranks: two processes share the card over ``gloo`` (NCCL refuses
   two ranks on one device; gloo stages CUDA tensors through host memory,
   so nothing here measures NVLink), the kernels built here first and only
   loaded by them. (a) The serve CLI under ``torch.distributed.run``,
   granite-8b at full width and depth on (1, 2) (``--mesh-model 2``, 4
   requests x 8 tokens; run beside phase 12 (a)'s CLI, ``rank_clis``): exit
   0, 4/4, B1 and B2 launched on each rank, a decode step's collectives equal to the dry run's for the same cell, the
   decode and collective ms, the greedy tokens beside phase 9 (d)'s; then a
   run on two ranks (``chip_smoke.py --multirank DIR``) gives the gathered
   prefill and decode logits, held at ``LOGITS_TOL`` against the one-rank
   ``torch`` backend on the same weights. (b) olmoe-1b-7b at full width and
   depth on (1, 2), ``moe_impl="shard_map"``: B5 at G = 32 on each rank,
   the logits against the one-rank body replaying the ranks' top-8 (5e-2),
   the router GEMM at ``ROUTER_TOL``. (c) granite-8b at full width, 1
   layer: ``Trainer.fit`` 1 step on (2, 1) (FSDP and data parallel),
   checkpoint, 1 on (1, 2), on two ranks of their own started before phase 5
   (``chip_smoke.py --background-ranks DIR``, ``start_background_ranks``,
   then phase 11's, 12's and 13's rank parts), which run beside phases 5-9;
   losses at ``TRAIN_LOSS_TOL`` and the first
   step's gathered gradients at ``TRAIN_GRAD_TOL`` against the one-rank
   ``torch`` backend. (d) ``device_bloom`` on 2**20 keys against phase 4's
   sieve filters, bit for bit the CPU's, and its ms. Planted faults: rank
   1's partial of one all-reduce zeroed, one extra all-reduce in the count,
   a rank's loss share alone, the gradients one row off, a key bit flipped.
   W1: where the CLI's greedy tokens on two ranks and phase 9 (d)'s on one
   first differ, the one-rank top-2 logit margin beside the two-rank
   logits' reading on the same tokens (``w1_readings``).
11. The serve CLI's configurations under a plan, on the same two ranks
   (their parts, ``mr11_*``, in the ranks started before phase 5): (a)
   granite-8b ``--quantize`` int8-dynamic and int4 on (1, 2) through the CLI
   at full depth (exit 0, 4/4, B1 and B2 on the rung on each rank, a decode
   step's collectives: the float dry run's, plus on int8-dynamic one MAX
   all-reduce a row-parallel dispatch), and a driver at 4 layers: each
   rank's codes and scales the one-rank quantization's shards (digests),
   the gathered logits at ``QUANT_LOGITS_TOL`` against the one-rank
   ``torch`` backend on the same quantized weights; (b) olmoe-1b-7b on its
   default ``moe_impl="global"``, dense and int8, B5 at G = 32 a rank: the
   dense logits replaying the ranks' top-8 (5e-2), int8's own routing on
   the first prompt at its rung's limit, the router at ``ROUTER_TOL``, the
   routing flips; (c) granite-8b at 2 layers on (2, 1), 2 of 4 slots a
   rank: logits (3e-2), decode keys equal to the one-rank plan's at M = 2,
   greedy tokens equal to a one-rank engine's, a decode step's collectives
   equal to the dry run's; (d) granite-8b at 4 layers ``--paged`` on
   (1, 2): tokens equal to a one-rank paged engine's, every decode step's
   logits (3e-2) against a one-rank run fed the ranks' tokens, the gather's
   device ms by rank. Planted faults: int8-dynamic's MAX all-reduce zeroed,
   int4's amax over half of K (its codes must differ), rank 1's MoE combine
   partials zeroed, a missing or extra collective in the counts.
12. The SSM, hybrid, VLM and encoder-decoder families across the same two
   ranks (their parts, ``mr12_*``, in the ranks started before phase 5),
   at full width: (a) mamba2-1.3b through the serve CLI on (1, 2) at full
   depth (exit 0, 4/4, B1 or B2 on each rank, a decode step's collectives
   equal to the dry run's) beside the one-rank CLI's greedy tokens; (b)
   mamba2-1.3b and zamba2-1.2b at full depth, llava-next-34b cut to 8 of 60
   layers with two image requests (576 patches each), whisper-large-v3 at
   full depth with two 1500-frame requests: a prefill and a decode step on
   (1, 2) against this process's one-rank ``cuda`` run on the same weights
   at ``LOGITS_TOL`` (the SSM and the hybrid layer by layer, each layer fed
   the ranks' input, the decode step also from the ranks' prefill cache,
   its shards joined; their end-to-end readings reported), each rank's B1
   and B2 launches, a decode step's collectives equal to the dry run's op
   by op, a warm step's split. Planted faults: rank 1's conv shard shifted
   by one channel (the SSM and the hybrid, in the prefill and, apart, in
   the decode step), rank 1's partial of an all-reduce zeroed (llava,
   whisper), an extra collective in the counts.
13. ``repro``'s production sharding rules across the same two ranks (their
   parts, ``mr13_*``, in the ranks started before phase 5, after phase
   12's; the one-rank ``cuda`` references there too, on rank 0 or, for
   training, on each rank in turn), at full width: (a) granite-8b cut to 4
   layers, decoding under the rule ``rules_for_cell`` gives the production
   mesh where its 8 kv heads do not divide ``model`` (``kv_heads`` whole,
   ``kv_seq`` over pod, data and model: each rank holds half of a 2048-
   position cache): four requests of 900-2000 tokens prefilled one by one
   into 4 slots, 2 decode steps, prefill and decode logits at
   ``LOGITS_TOL``; (b) zamba2-1.2b cut to 12 layers, one row under
   ``long_500k``'s rule on (2, 1) (``kv_seq`` on data), its cache cut to
   6144 positions and a 4096-token prompt: the prefill and a decode step
   layer by layer (``layer_replayed_diff``, the step from the ranks'
   prefill cache made whole), end to end reported; (c) granite-8b cut to 2
   layers trained under ``train_4k``'s rule (``seq`` on model,
   sequence-parallel) on (1, 2), 2 x 2048 tokens: the loss at
   ``TRAIN_LOSS_TOL``, the gradients at ``TRAIN_GRAD_TOL`` (each rank's
   shards against the reference's slices), two AdamW steps' losses; two
   Adafactor steps on (1, 2) and on (2, 1): losses, masters and factored
   moments. For each: each rank's B1/B2 launches, a step's collectives
   equal to the dry run's record of the same cell under the same rules op
   by op (traced in phase 9 (a)'s child, ``chiprun_out/phase13_dryrun.json``),
   a warm step's split. Planted faults: rank 1's partial softmax dropped
   from the combine ((a), (b)), rank 1's reduce-scatters keeping the
   neighbour's slice ((c)), an extra all-reduce in the counts.
14. The compiled decode step (``serve/graphs.py``): on the card each
   engine of one rank captures its warm decode step as a CUDA graph per
   shape key and replays it, so every one-rank serve run of phases 3-9
   replays; its launch checks count each eager dispatch once and each
   captured step's launches once a replay (``b5_called_for``). Its parts run
   where their weights are loaded: (a) in phase 3, granite-8b and
   olmoe-1b-7b dense and on each of ``RUNGS``, each served run against the
   same 4 requests x 8 tokens served again under ``disable_graphs()``
   (``graph_vs_eager``): greedy tokens equal, each decode step's logits at
   the run's ``LOGITS_TOL`` / ``QUANT_LOGITS_TOL`` (0 expected: the same
   kernels on the same inputs), the mode, captures and replays, a warm
   replayed step's split beside the eager one's (``decode_breakdown``), the
   capture seconds and the graph pool's bytes; (b) in phase 5, the paged
   engine (granite-8b whole-prompt and chunked, olmoe x 2): the same
   against eager, one capture per padded table width; (c) in phases 6 and
   7, every ``serve_run`` (nemotron, gemma3, mistral x 2, qwen3 x 2, mamba2,
   zamba2, llava; whisper's ``EncDec`` loop is no engine and stays eager);
   (d) in phase 4, granite-8b with an ``AdaptiveTuner`` as phase 4's on the
   analytical model (so its eager twin commits the same records at the same
   steps): a capture after a hot swap, tokens equal eager; (e) in phase 3,
   two planted faults on granite-8b's dense engine, a replay that skips
   refreshing the token buffer and a captured step whose cache writes go
   to a copy, each of which must change the tokens or read 3x the limit;
   (f) phases 10-13 record each engine's and plan's mode across ranks, which
   must read "eager". The record is under ``compiled``.

Tolerances: a kernel output ``x`` agrees with its reference ``r`` when
``max|x - r| <= tol * max(1, max|r|)``: 1e-4 for f32 inputs (f32 sums in
another order), 2e-2 for bf16 (one bf16 rounding of the output). The served
logits agree within ``LOGITS_TOL`` x max|logit|: 3e-2 for granite-8b's 36
layers of bf16 activations rounded at different points of two summation
orders (a sound run reads about 1.7e-2 on the seeded weights), and 5e-2 for
olmoe-1b-7b. There the same roundings also flip near-tied top-8 routing
choices (the run counts them), and each flip moves the logits further: with
each backend routing on its own, sound implementations that only sum K in
another order read 4.7e-2 to 6.3e-2 against the ``torch`` backend
(``logits_probe.py --spread``), so that reading cannot hold a 5e-2 limit.
olmoe's dense run therefore holds the limit on the reading with the
``torch`` backend replaying the ``cuda`` run's top-8 choices
(``routing_replay``: the kernels' rounding without the flips it sets off,
7.8e-3 to 8.7e-3), and, so that the replay hides no fault of the router's
own GEMM, holds each layer's router logits against ``torch.matmul`` of the
same input at the f32 kernel tolerance (``ROUTER_TOL``); the reading with
each backend routing alone is reported. Its planted fault is read with the
fault run's choices replayed. The quantized kernels keep 1e-4 for
f32 activations (the int8 -> f32 widening is exact and the int8 x int8
k-steps are exact int32 sums) and 2e-2 for bf16 ones; the quantized runs'
logits limits are ``QUANT_LOGITS_TOL``, set from sound readings with each
backend routing alone (so they hold that reading, the replayed one is
reported), and every planted fault must read at least 3 times its limit.

The line before the last is the ``kernels`` JSON: every kernel (B6's launches
from the baseline comparison, the others' from the served runs), and one entry
per (kernel, rung) that a served path ran; each entry names the mainloop
it ran (``mainloop``: ``mma`` or ``fma``); B3 has no entry of its own, being
fused into B2 (``streamk_phase1``); the last line is ``{"ok": true,
"device": {...}}``. Details go to ``chiprun_out/chip_smoke.json`` (phase 6's
runs, their launch counts by kernel included, under ``archs``, phase 7's
under ``families``, phase 8's under ``train``, phase 9's under ``shard``;
the dry run's artifacts go to ``chiprun_out/phase9_dryrun.json``). Each
kernel entry of the served runs also carries ``train_launches``: its
launches in phase 8's ``Trainer.fit``, by trained model, and phase 9's
``shard_gemm_launches`` (the per-shard GEMMs) and ``moe_variant_launches``
(olmoe on each MoE variant), and phase 10's ``multirank_launches`` (each
rank's counters, by run; phase 10's record is under ``multirank``, phase
11's under ``serve_ranks``, phase 12's under ``families_ranks``, phase 13's
under ``production_rules``).
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time
import traceback
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BF16 = 989e12  # FLOP/s, H100 SXM dense tensor-core peak (data sheet)
PEAK_F32 = 67e12  # FLOP/s, H100 SXM f32 outside the tensor cores
HBM_BW = 3.35e12  # B/s, H100 SXM HBM3 (data sheet)
SLICE_NK = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336), (49152, 4096)]
GRANITE_NK = [(n, k, "bfloat16") for n, k in SLICE_NK]
#: olmoe-1b-7b's plain projections (N, K, dtype): attention, lm_head, router
OLMOE_NK = [(2048, 2048, "bfloat16"), (50304, 2048, "bfloat16"), (64, 2048, "float32")]
#: olmoe-1b-7b's expert GEMMs (G, M, N, K): moe.gate/in (2048 -> 1024) and
#: moe.out (1024 -> 2048) at decode capacity (M = 4 with 4 slots) and prompt
#: capacity (M = 16 for 16-64 tokens)
GROUPED_SHAPES = ((64, 4, 1024, 2048), (64, 4, 2048, 1024), (64, 16, 1024, 2048),
                  (64, 16, 2048, 1024))
#: a small grouped shape whose rows are not 16-byte aligned (element-wise staging)
GROUPED_RAGGED = (5, 20, 302, 200)
REPLACES = {
    "dp_gemm_region": "src/repro/kernels/dp/dp_gemm.py:40",
    "streamk_phase1": "src/repro/kernels/streamk/streamk_gemm.py:78",
    "grouped_streamk_sk": "src/repro/kernels/streamk/grouped.py:93",
    "grouped_streamk_dp": "src/repro/kernels/streamk/grouped.py:156",
    "splitk_partials": "src/repro/kernels/splitk/splitk_gemm.py:28",
}
SOURCE = "src/repro_torch/csrc/stream_k.cuh"  # instantiated by stream_k.cu and quant_*.cu
GROUPED_SOURCE = "src/repro_torch/csrc/grouped.cuh"  # by grouped.cu, grouped_bf16.cu, quant_*.cu
SOURCES = dict.fromkeys(("dp_gemm_region", "streamk_phase1"), SOURCE)
SOURCES.update(dict.fromkeys(("grouped_streamk_sk", "grouped_streamk_dp"), GROUPED_SOURCE))
SOURCES["splitk_partials"] = "src/repro_torch/csrc/splitk.cuh"  # by stream_k.cu and quant_*.cu
#: the kernels a served path runs (B6 has no served caller)
SERVED_KERNELS = [name for name in REPLACES if name != "splitk_partials"]
PEAK_INT8 = 1979e12  # OP/s, H100 SXM dense int8 tensor-core peak (data sheet)
#: the quantization ladder as served (bf16 activations): rung -> (bits, act_bits, the source
#: that instantiates its B1, B2 and B5)
RUNGS = {"int8": (8, None, "src/repro_torch/csrc/quant_bf16_i8.cu"),
         "int8-dynamic": (8, 8, "src/repro_torch/csrc/quant_i8_i8.cu"),
         "int4": (4, None, "src/repro_torch/csrc/quant_bf16_i4.cu")}
#: the quantized sweep's operand pairs: (name, activation dtype, weight bits, int8
#: activations, tolerance); f32 activations keep 1e-4 (the int8 -> f32 widening is exact and
#: the int8 x int8 k-steps are exact int32 sums), bf16 ones 2e-2
QUANT_PAIRS = (("f32*int8", "float32", 8, False, 1e-4), ("bf16*int8", "bfloat16", 8, False, 2e-2),
               ("int8*int8", "float32", 8, True, 1e-4), ("f32*int4", "float32", 4, False, 1e-4),
               ("bf16*int4", "bfloat16", 4, False, 2e-2), ("int8*int4", "float32", 4, True, 1e-4))
#: the rungs timed in phase 2: the served ones, and int4 weights against int8 activations
#: (``quantize_weight(bits=4, act_bits=8)``), which no serve rung reaches
TIMED_RUNGS = dict(RUNGS, **{"int4-dynamic": (4, 8, "src/repro_torch/csrc/quant_i8_i4.cu")})
#: served prefill logits vs the torch backend, x max|logit|, per model: a
#: sound granite-8b run reads 1.7e-2 and its planted fault 0.39; olmoe-1b-7b's
#: limit holds the reading with the torch backend replaying the cuda run's
#: top-8 choices (7.8e-3 to 8.7e-3 on the H100; each backend routing alone
#: reads 2.3e-2 to 6.3e-2 between sound implementations, from routing flips)
LOGITS_TOL = {"granite-8b": 3e-2, "olmoe-1b-7b": 5e-2, "nemotron-4-15b": 3e-2,
              "gemma3-27b": 3e-2, "mistral-large-123b": 3e-2, "qwen3-moe-235b-a22b": 5e-2,
              "mamba2-1.3b": 3e-2, "zamba2-1.2b": 3e-2, "llava-next-34b": 3e-2,
              "whisper-large-v3": 3e-2}
#: a MoE layer's router logits (an f32 GEMM) against ``torch.matmul`` of the
#: same input, x max(1, max|ref|): the f32 kernel tolerance
ROUTER_TOL = 1e-4
#: the limits of the quantized runs, against the torch backend on the same quantized weights,
#: from their sound readings on the H100 (x max|logit|): granite-8b reads 1.96e-2 (int8), 0
#: (int8-dynamic: the per-row int8 requantization of every activation absorbs the two
#: backends' roundings, so the logits come out bit-identical) and 1.90e-2 (int4), so it keeps
#: its dense 3e-2; olmoe-1b-7b reads 4.46e-2, 0 and 8.17e-2, its routing flips compounding on
#: the coarser weights, so 7e-2, 5e-2 (its dense limit) and 1.2e-1. The planted fault of a
#: quantized run, every DP and grouped GEMM on the rung dropping its last K chunk, must read
#: at least 3 times the limit.
QUANT_LOGITS_TOL = {
    ("granite-8b", "int8"): 3e-2, ("granite-8b", "int8-dynamic"): 3e-2,
    ("granite-8b", "int4"): 3e-2, ("olmoe-1b-7b", "int8"): 7e-2,
    ("olmoe-1b-7b", "int8-dynamic"): 5e-2, ("olmoe-1b-7b", "int4"): 1.2e-1,
}
N_SLOTS, MAX_SEQ = 4, 256


def serve_prompts(vocab_size):
    """The served run's 4 seeded prompts of 16-64 tokens."""
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab_size, size=int(rng.integers(16, 65))) for _ in range(4)]


def log(*args):
    print(*args, flush=True)


def close(got, want, tol, what):
    """max|got - want| after checking it is within tol * max(1, max|want|)."""
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    if err > tol * scale:
        raise AssertionError(f"{what}: max|err| {err:.3e} > {tol} * {scale:.3e}")
    return err


def device_ms_by_name(prof):
    """Milliseconds of device activity (kernels, copies) in a profiler
    trace, summed by name."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return by_name


def time_ms(fn, iters=20, warmup=3):
    """(device ms, event ms) per call over ``iters`` calls, by CUDA events.

    Event ms: events around ``iters`` calls as the host issues them, so it
    also counts the gaps while the host prepares the next launch. Device
    ms: the same calls queued behind a spin kernel that keeps the card busy
    for about twice the host's time to issue them, so the events see the
    calls run back to back — the kernels' own time. The two differ where the
    host cannot keep the card fed."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    issue_s = time.perf_counter() - t0
    event_ms = start.elapsed_time(end) / iters
    torch.cuda._sleep(int(2 * issue_s * 2e9))  # cycles: about 2 x issue_s at <= 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, event_ms


# ---------------------------------------------------------------------------
# Phase 1: device and build
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    from repro_torch.kernels import cuda_lib

    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"needs a Hopper card (capability (9, 0)), found {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    CARD["compute_mode"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"compute mode {CARD['compute_mode']}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    cuda_lib.library()
    build_s = time.perf_counter() - t0
    log(f"kernels built from src/repro_torch/csrc/*.cu in {build_s:.1f}s -> "
        f"{cuda_lib.build_info['path']}")
    for line in cuda_lib.build_info["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())
    return smi, build_s


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _operands(m, n, k, dtype, gen):
    import torch

    a = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    b = (torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)).to(dtype)
    bias = torch.randn(n, generator=gen, device="cuda").to(dtype)
    operand = torch.randn(m, n, generator=gen, device="cuda").to(dtype)
    return a, b, bias, operand


def _used_slots(partials, part):
    """(sk_tiles, mc + 1, 1, 1): the contributor slots of split tiles, below
    the tile's contributor count: those the card defines on every pair (a
    tile that one block owns whole is flushed from registers; dense f32
    parks it in slot 0 first)."""
    import torch

    from repro_torch.kernels.streamk.streamk_gemm import n_contributors

    nc = n_contributors(part, partials.device)
    used = torch.arange(partials.shape[1], device=partials.device)[None, :] < nc[:, None]
    return (used & (nc > 1)[:, None])[:, :, None, None]


#: the full sweep's shapes: the main one, a ragged one whose rows stay
#: 16-byte aligned (the cp.async path with zero-filled edges), and one whose
#: rows do not (the element-wise staging path)
SWEEP_SHAPES = ((64, 4096, 4096), (20, 392, 520), (17, 302, 200))


def sweep(gen):
    """All policies x 2 g x 2 dtypes x 4 epilogues at each sweep shape."""
    import torch

    from repro_torch.core.op import Epilogue
    from repro_torch.core.policies import ALL_POLICIES
    from repro_torch.core.selector import default_selector
    from repro_torch.core.workpart import GemmShape, partition
    from repro_torch.kernels.dp.dp_gemm import dp_gemm_region, dp_gemm_region_plain
    from repro_torch.kernels.streamk import ops
    from repro_torch.kernels.streamk.ref import gemm_ref
    from repro_torch.kernels.streamk.streamk_gemm import (
        streamk_fixup_plain, streamk_phase1_plain, streamk_region,
    )
    from repro_torch.core.op import GemmOp
    from repro_torch.core.gemm import dtype_name

    errs = {"dp_gemm_region": 0.0, "streamk_phase1": 0.0, "gemm": 0.0}
    sel = default_selector("cuda")
    cases = 0
    for (m, n, k), dtype, tol in (
        (shape, dt, tol) for shape in SWEEP_SHAPES
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4))
    ):
        a, b, bias, operand = _operands(m, n, k, dtype, gen)
        cfg = sel.select_op(GemmOp.plain(m, n, k, in_dtype=dtype_name(dtype))).cfg
        ref_acc = gemm_ref(a, b, torch.float32)
        for epi_name, epi, kw in (
            ("none", Epilogue(), {}),
            ("mul_silu", Epilogue(binary="mul_silu"), {"operand": operand}),
            ("bias+gelu", Epilogue(activation="gelu", bias=True), {"bias": bias}),
            ("square", Epilogue(activation="square"), {}),  # nemotron-4-15b's MLP
        ):
            want = epi.apply(ref_acc, **{key: v for key, v in kw.items()}).to(dtype)
            for pol in ALL_POLICIES:
                for g in (66, 132):
                    what = (f"{m}x{n}x{k} {dtype_name(dtype)} {pol.name} g={g} {cfg.name} "
                            f"{epi_name}")
                    part = partition(GemmShape(m, n, k), cfg, g, pol)
                    c = ops.gemm(a, b, policy=pol, cfg=cfg, g=g, epilogue=epi, **kw)
                    errs["gemm"] = max(errs["gemm"], close(c, want, tol, what))
                    c_k = torch.zeros(m, n, dtype=dtype, device="cuda")
                    c_p = torch.zeros(m, n, dtype=dtype, device="cuda")
                    if part.sk_tiles:
                        _, p_k = streamk_region(a, b, part, c_k, epilogue=epi, workspace=True,
                                                **kw)
                        p_p = streamk_phase1_plain(a, b, part)
                        used = _used_slots(p_k, part)
                        streamk_fixup_plain(p_p, part, c_p, epilogue=epi, **kw)
                        errs["streamk_phase1"] = max(
                            errs["streamk_phase1"],
                            close(torch.where(used, p_k, 0.0), torch.where(used, p_p, 0.0), tol,
                                  what + " B2 slots"),
                            close(c_k, c_p, tol, what + " B2+B3"))
                    if part.dp_tiles:
                        dp_gemm_region(a, b, cfg, c=c_k, tile_offset=part.sk_tiles, g=g,
                                       epilogue=epi, **kw)
                        dp_gemm_region_plain(a, b, cfg, c_p, tile_offset=part.sk_tiles,
                                             epilogue=epi, **kw)
                        errs["dp_gemm_region"] = max(errs["dp_gemm_region"],
                                                     close(c_k, c_p, tol, what + " B1"))
                    cases += 1
    torch.cuda.synchronize()
    return errs, cases


def slice_ms(arch):
    """The M of every plain GEMM the served run issues: lm_head's single row,
    the decode batch, the sweep's 64 and each prompt's prefill length (ragged
    edges inside a 64-row sub-block)."""
    from repro_torch.configs import get_config

    lens = {len(p) for p in serve_prompts(get_config(arch).vocab_size)}
    return sorted({1, N_SLOTS, 64} | lens)


def slice_shapes(gen, arch, nk_dtypes, ms=None):
    """A model's plain projection shapes under the H100 pick, DP and ALL_SK,
    at each M of ``ms`` (default: ``slice_ms(arch)``)."""
    import torch

    from repro_torch.core.gemm import as_dtype, dtype_name
    from repro_torch.core.op import GemmOp
    from repro_torch.core.policies import ALL_SK, DP
    from repro_torch.core.selector import default_selector
    from repro_torch.core.workpart import GemmShape, partition
    from repro_torch.kernels.streamk import ops
    from repro_torch.kernels.streamk.ref import gemm_ref
    from repro_torch.kernels.streamk.streamk_gemm import streamk_region

    sel = default_selector("cuda")
    worst = 0.0
    picks = []
    for m in ms or slice_ms(arch):
        for n, k, dt in nk_dtypes:
            a, b, _, _ = _operands(m, n, k, as_dtype(dt), gen)
            tol = 2e-2 if a.dtype == torch.bfloat16 else 1e-4
            s = sel.select_op(GemmOp.plain(m, n, k, in_dtype=dtype_name(a.dtype)))
            picks.append({"arch": arch, "m": m, "n": n, "k": k, "dtype": dt,
                          "policy": s.policy.name, "tile": s.cfg.name, "g": s.g})
            want = gemm_ref(a, b, torch.float32)
            for pol, cfg, g in ((s.policy, s.cfg, s.g), (DP, s.cfg, s.g), (ALL_SK, s.cfg, s.g)):
                c = ops.gemm(a, b, policy=pol, cfg=cfg, g=g)
                worst = max(worst, close(c, want, tol, f"{m}x{n}x{k} {dt} {pol.name} {cfg.name}"))
            # determinism: the sweep with its ordered fix-up is bit-identical
            part = partition(GemmShape(m, n, k), s.cfg, s.g, ALL_SK)
            c1 = streamk_region(a, b, part, torch.empty(m, n, dtype=a.dtype, device="cuda"))
            c2 = streamk_region(a, b, part, torch.empty(m, n, dtype=a.dtype, device="cuda"))
            if not torch.equal(c1, c2):
                raise AssertionError(f"{m}x{n}x{k}: B2+B3 not bitwise deterministic")
    torch.cuda.synchronize()
    return worst, picks


def arch_nk(cfg):
    """A config's plain projection shapes (N, K, dtype): attention q, k/v and
    o, the dense MLP's in (and gate) and out, a MoE model's f32 router,
    Mamba2's fused input projection and its output projection, and the
    head."""
    d, bf = cfg.d_model, "bfloat16"
    nk = []
    if cfg.n_heads:
        qd, kvd = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
        nk += [(qd, d, bf), (kvd, d, bf), (d, qd, bf)]
    if cfg.family == "moe":
        nk.append((cfg.n_experts, d, "float32"))
    elif cfg.d_ff:
        nk += [(cfg.d_ff, d, bf), (d, cfg.d_ff, bf)]
    if cfg.ssm_state:
        din, ds = cfg.d_inner, cfg.ssm_state
        nk += [(2 * din + 2 * ds + cfg.ssm_heads, d, bf), (d, din, bf)]
    return list(dict.fromkeys(nk + [(cfg.vocab_size, d, bf)]))  # gemma3's q and o coincide


def _rotating(b, min_bytes=200 * 2**20):
    """Copies of a weight whose total exceeds the 50 MB L2, so timed calls
    read it from device memory as a decode step does."""
    copies = max(1, math.ceil(min_bytes / (b.numel() * b.element_size())))
    return [b.clone() for _ in range(copies)]


def _sk_region_bytes_ops(part, m, n, k, a_bytes, b_bytes, c_bytes, extra_bytes=0):
    """(bytes, operations) that the function of the fused Stream-K region,
    its C tiles = epilogue(A @ B), needs on its real data (rows < M, columns
    < N), for A, B and C elements of ``a_bytes``, ``b_bytes`` (0.5 for
    packed int4) and ``c_bytes``, and ``extra_bytes`` of dequant scales:
    each A row and B column the region touches read once, each C element
    written once, 2 operations per multiply-add. The split tiles' slot
    round trip and their fix-up additions are the kernel's own
    decomposition, not the function's, and are not counted."""
    cfg = part.cfg
    rows, cols, elems = set(), set(), 0
    for c in part.contributions:  # one per Stream-K tile
        tm, tn = part.tile_mn(c.tile)
        rows.add(tm)
        cols.add(tn)
        elems += (max(0, min(m, (tm + 1) * cfg.bm) - tm * cfg.bm)
                  * max(0, min(n, (tn + 1) * cfg.bn) - tn * cfg.bn))
    a_rows = sum(max(0, min(m, (t + 1) * cfg.bm) - t * cfg.bm) for t in rows)
    b_cols = sum(max(0, min(n, (t + 1) * cfg.bn) - t * cfg.bn) for t in cols)
    read = (a_rows * a_bytes + b_cols * b_bytes) * k
    return read + elems * c_bytes + extra_bytes, 2 * elems * k


def bound_ms(nbytes, ops, peak=PEAK_BF16):
    t_bytes, t_ops = nbytes / HBM_BW, ops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_kernels(gen):
    """Each kernel at a decode shape (M = 4 slots) where the H100 selector
    uses it: B1 at mlp.gate (4, 14336, 4096, DP), B2 (with B3 fused in) at
    mlp.out (4, 4096, 14336, ALL_SK); then each again, beside its plain
    version, at the sweep shape (64, 4096, 4096)."""
    import torch

    from repro_torch.core.gemm import dtype_name
    from repro_torch.core.op import GemmOp
    from repro_torch.core.policies import ALL_SK
    from repro_torch.core.selector import default_selector
    from repro_torch.core.workpart import GemmShape, partition
    from repro_torch.kernels.dp.dp_gemm import dp_gemm_region, dp_gemm_region_plain
    from repro_torch.kernels.streamk import ops as sk_ops
    from repro_torch.kernels.streamk.streamk_gemm import (
        streamk_fixup_plain, streamk_phase1_plain, streamk_region,
    )

    def plain_region(a, b, part, c):
        return streamk_fixup_plain(streamk_phase1_plain(a, b, part), part, c)

    sel = default_selector("cuda")
    out = {}

    # B1 ------------------------------------------------------------------
    m, n, k = 4, 14336, 4096
    a, b, _, _ = _operands(m, n, k, torch.bfloat16, gen)
    s = sel.select_op(GemmOp.plain(m, n, k, in_dtype=dtype_name(a.dtype)))
    if s.policy.is_streamk:
        raise AssertionError(f"expected a DP pick at {m}x{n}x{k}, got {s.policy.name}")
    c = torch.empty(m, n, dtype=a.dtype, device="cuda")
    c_p = torch.empty_like(c)
    err = close(dp_gemm_region(a, b, s.cfg, c=c, g=s.g),
                dp_gemm_region_plain(a, b, s.cfg, c_p), 2e-2, "B1 timing shape")
    bs = _rotating(b)
    it = iter(range(10**9))
    ms, ev = time_ms(lambda: dp_gemm_region(a, bs[next(it) % len(bs)], s.cfg, c=c, g=s.g))
    plain, plain_ev = time_ms(lambda: dp_gemm_region_plain(a, bs[next(it) % len(bs)], s.cfg, c_p))
    lib, lib_ev = time_ms(lambda: torch.matmul(a, bs[next(it) % len(bs)]))
    bnd, by = bound_ms((m * k + k * n + m * n) * 2, 2 * m * n * k)
    out["dp_gemm_region"] = dict(shape=[m, n, k], policy=s.policy.name, tile=s.cfg.name, g=s.g,
                                 max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                                 bound_by=by, library_ms=lib, event_ms=ev,
                                 plain_event_ms=plain_ev, library_event_ms=lib_ev)

    # B2 with B3 fused in -------------------------------------------------------
    m, n, k = 4, 4096, 14336
    a, b, _, _ = _operands(m, n, k, torch.bfloat16, gen)
    s = sel.select_op(GemmOp.plain(m, n, k, in_dtype=dtype_name(a.dtype)))
    part = partition(GemmShape(m, n, k), s.cfg, s.g, s.policy)
    if not part.sk_tiles or part.dp_tiles:
        raise AssertionError(f"expected an ALL_SK pick at {m}x{n}x{k}, got {s.policy.name}")
    c = torch.empty(m, n, dtype=a.dtype, device="cuda")
    c_p = torch.empty_like(c)
    c_k, p_k = streamk_region(a, b, part, c, workspace=True)
    used = _used_slots(p_k, part)
    p_p = streamk_phase1_plain(a, b, part)
    err2 = max(close(torch.where(used, p_k, 0.0), torch.where(used, p_p, 0.0), 2e-2,
                     "B2 timing, split-tile slots"),
               close(c_k, streamk_fixup_plain(p_p, part, c_p), 2e-2, "B2+B3 timing"))
    bs = _rotating(b)
    ms2, ev2 = time_ms(lambda: streamk_region(a, bs[next(it) % len(bs)], part, c))
    # one call: the plain sweep issues hundreds of small launches per call
    plain2, plain_ev2 = time_ms(lambda: plain_region(a, bs[next(it) % len(bs)], part, c_p),
                                iters=1)
    bnd2, by2 = bound_ms(*_sk_region_bytes_ops(part, m, n, k, 2, 2, 2))
    # under ALL_SK the region is the whole GEMM: torch.matmul computes it
    lib2, lib2_ev = time_ms(lambda: torch.matmul(a, bs[next(it) % len(bs)]))
    composed, composed_ev = time_ms(
        lambda: sk_ops.gemm(a, bs[next(it) % len(bs)], policy=ALL_SK, cfg=s.cfg, g=s.g))
    out["streamk_phase1"] = dict(
        shape=[m, n, k], policy=s.policy.name, tile=s.cfg.name, g=s.g, max_abs_err=err2,
        ms=ms2, plain_ms=plain2, bound_ms=bnd2, bound_by=by2, library_ms=lib2, event_ms=ev2,
        plain_event_ms=plain_ev2, library_event_ms=lib2_ev,
        library_of="torch.matmul of the whole GEMM (the ALL_SK region computes it)",
        composed_ms=composed, composed_event_ms=composed_ev)

    # each kernel beside its plain version at the sweep shape (device ms)
    m, n, k = SWEEP_SHAPES[0]
    a, b, _, _ = _operands(m, n, k, torch.bfloat16, gen)
    bs = _rotating(b)
    cfg = sel.select_op(GemmOp.plain(m, n, k, in_dtype=dtype_name(a.dtype))).cfg
    part = partition(GemmShape(m, n, k), cfg, 132, ALL_SK)
    c = torch.empty(m, n, dtype=a.dtype, device="cuda")
    c_p = torch.empty_like(c)
    pairs = {
        "dp_gemm_region": (lambda: dp_gemm_region(a, bs[next(it) % len(bs)], cfg, c=c, g=132),
                           lambda: dp_gemm_region_plain(a, bs[next(it) % len(bs)], cfg, c_p)),
        "streamk_phase1": (lambda: streamk_region(a, bs[next(it) % len(bs)], part, c),
                           lambda: plain_region(a, bs[next(it) % len(bs)], part, c_p)),
    }
    for name, (kernel, plain) in pairs.items():
        out[name].update(sweep_shape=[m, n, k, cfg.name], sweep_ms=time_ms(kernel)[0],
                         sweep_plain_ms=time_ms(plain, iters=1)[0])
    return out


def time_main_path_gemms(gen, m):
    """The whole composition (every kernel the pick launches) at each slice
    shape, beside torch.matmul and the bound of the full GEMM."""
    import torch

    from repro_torch.core.gemm import dtype_name
    from repro_torch.core.op import GemmOp
    from repro_torch.core.selector import default_selector
    from repro_torch.kernels.streamk import ops

    sel = default_selector("cuda")
    rows = []
    for n, k in SLICE_NK:
        a, b, _, _ = _operands(m, n, k, torch.bfloat16, gen)
        s = sel.select_op(GemmOp.plain(m, n, k, in_dtype=dtype_name(a.dtype)))
        bs = _rotating(b)
        it = iter(range(10**9))
        ms, ev = time_ms(lambda: ops.gemm(a, bs[next(it) % len(bs)], policy=s.policy,
                                          cfg=s.cfg, g=s.g))
        lib, lib_ev = time_ms(lambda: torch.matmul(a, bs[next(it) % len(bs)]))
        bnd, by = bound_ms((m * k + k * n + m * n) * 2, 2 * m * n * k)
        rows.append(dict(shape=[m, n, k], policy=s.policy.name, tile=s.cfg.name, g=s.g, ms=ms,
                         event_ms=ev, library_ms=lib, library_event_ms=lib_ev, bound_ms=bnd,
                         bound_by=by))
        log(f"  gemm {m}x{n}x{k} {s.policy.name}/{s.cfg.name} g={s.g}: device {ms:.4f} ms, "
            f"events {ev:.4f} ms (torch.matmul {lib:.4f} / {lib_ev:.4f} ms, bound {bnd:.4f} ms "
            f"by {by})")
    return rows


# ---------------------------------------------------------------------------
# Phase 2b: B5, the grouped kernel, against its plain version
# ---------------------------------------------------------------------------


def _grouped_operands(g, m, n, k, dtype, gen):
    import torch

    a = torch.randn(g, m, k, generator=gen, device="cuda").to(dtype)
    b = (torch.randn(g, k, n, generator=gen, device="cuda") / math.sqrt(k)).to(dtype)
    bias = torch.randn(g, n, generator=gen, device="cuda").to(dtype)
    operand = torch.randn(g, m, n, generator=gen, device="cuda").to(dtype)
    return a, b, bias, operand


def grouped_pick(g, m, n, k, dtype):
    """The H100 selector's pick for a fused grouped op (no epilogue)."""
    from repro_torch.core.gemm import dtype_name
    from repro_torch.core.op import GemmOp
    from repro_torch.core.selector import default_selector

    dt = dtype_name(dtype)
    return default_selector("cuda").select_op(
        GemmOp(m, n, k, g=g, kind="grouped", in_dtype=dt, out_dtype=dt, fused=True))


def _grouped_kernel_name(policy):
    from repro_torch.core.policies import PolicyKind

    return "grouped_streamk_dp" if policy.kind == PolicyKind.DP else "grouped_streamk_sk"


def _splits_tiles(sizes, n, k, cfg, g):
    """True when some Stream-K workgroup boundary falls inside a tile."""
    from repro_torch.core.workpart import cdiv

    ipt = cdiv(k, cfg.bk)
    total = sum(cdiv(s, cfg.bm) for s in sizes) * cdiv(n, cfg.bn) * ipt
    ipw = cdiv(total, g)
    return total > ipw and ipw % ipt != 0


def sweep_grouped(gen):
    """B5 at olmoe-1b-7b's expert shapes and a small unaligned one: every
    policy (DP; ALL_SK and the HYBRIDs, which run the Stream-K form) x g in
    {66, 132, 264} x {bf16 (2e-2), f32 (1e-4)} x epilogues {none, gelu,
    bias, mul_silu, square} x group sizes {full, ragged with empty groups}, against
    the plain version and per-group ``gemm_ref``; all-empty sizes launch
    nothing; the Stream-K form with split tiles is bit-identical across two
    runs."""
    import torch

    from repro_torch.core.op import Epilogue
    from repro_torch.core.policies import ALL_POLICIES, ALL_SK
    from repro_torch.kernels.common import count_launches
    from repro_torch.kernels.streamk.grouped import (
        gemm_grouped_streamk, gemm_grouped_streamk_plain,
    )
    from repro_torch.kernels.streamk.ref import gemm_ref

    errs = {"grouped_streamk_sk": 0.0, "grouped_streamk_dp": 0.0}
    cases = bitwise = 0
    rng = np.random.default_rng(1)
    for gc, m, n, k in GROUPED_SHAPES + (GROUPED_RAGGED,):
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            a, b, bias, operand = _grouped_operands(gc, m, n, k, dtype, gen)
            cfg = grouped_pick(gc, m, n, k, dtype).cfg
            ragged = (0, m) + tuple(int(s) for s in rng.integers(0, m + 1, size=gc - 2))
            for sizes in ((m,) * gc, ragged):
                dead = (torch.arange(m, device="cuda")[None, :]
                        >= torch.tensor(sizes, device="cuda")[:, None])[:, :, None]
                for epi, kw in ((Epilogue(), {}), (Epilogue(activation="gelu"), {}),
                                (Epilogue(bias=True), {"bias": bias}),
                                (Epilogue(binary="mul_silu"), {"operand": operand}),
                                (Epilogue(activation="square"), {})):
                    what = f"B5 {gc}x{m}x{n}x{k} {dtype} {cfg.name} {epi.name} sizes={sizes}"
                    want = gemm_grouped_streamk_plain(a, b, sizes=sizes, out_dtype=dtype,
                                                      epilogue=epi, **kw)
                    ref = torch.zeros_like(want)
                    for i, s in enumerate(sizes):
                        if s:
                            ref[i, :s] = epi.apply(
                                gemm_ref(a[i, :s], b[i], torch.float32),
                                bias=None if "bias" not in kw else bias[i],
                                operand=None if "operand" not in kw else operand[i, :s],
                            ).to(dtype)
                    close(want, ref, tol, what + " plain vs gemm_ref")
                    for pol in ALL_POLICIES:
                        for g in (66, 132, 264):
                            got = gemm_grouped_streamk(a, b, policy=pol, cfg=cfg, g=g,
                                                       out_dtype=dtype, epilogue=epi,
                                                       group_sizes=sizes, **kw)
                            name = _grouped_kernel_name(pol)
                            label = f"{what} {pol.name} g={g}"
                            errs[name] = max(errs[name], close(got, want, tol, label),
                                             close(got, ref, tol, label + " vs gemm_ref"))
                            if torch.where(dead, got, 0).abs().max().item() != 0:
                                raise AssertionError(f"{label}: rows past a group's size are "
                                                     "not 0")
                            cases += 1
                for g in (66, 132, 264):
                    if _splits_tiles(sizes, n, k, cfg, g):
                        c1, c2 = (gemm_grouped_streamk(a, b, policy=ALL_SK, cfg=cfg, g=g,
                                                       group_sizes=sizes) for _ in range(2))
                        if not torch.equal(c1, c2):
                            raise AssertionError(f"B5 {gc}x{m}x{n}x{k} {cfg.name} g={g}: the "
                                                 "Stream-K form is not bitwise deterministic")
                        bitwise += 1
            with count_launches() as launched:
                out = gemm_grouped_streamk(a, b, policy=ALL_SK, cfg=cfg, g=132,
                                           group_sizes=(0,) * gc)
            if launched or out.any():
                raise AssertionError(f"B5 all-empty: launched {launched}, output not all 0")
    torch.cuda.synchronize()
    if not bitwise:
        raise AssertionError("no B5 case split a tile: the hand-off went untested")
    return errs, cases, bitwise


def time_grouped(gen):
    """B5 at olmoe-1b-7b's expert shapes (bf16, no epilogue) under the H100
    pick and under the other form, beside its plain version, ``torch.bmm``
    (the yardstick) and the bound. Each call reads 268 MB of weights, more
    than the 50 MB L2, so no rotation is needed."""
    import torch

    from repro_torch.core.policies import ALL_SK, DP, PolicyKind
    from repro_torch.kernels.streamk.grouped import (
        gemm_grouped_streamk, gemm_grouped_streamk_plain,
    )

    rows = []
    for gc, m, n, k in GROUPED_SHAPES:
        a, b, _, _ = _grouped_operands(gc, m, n, k, torch.bfloat16, gen)
        s = grouped_pick(gc, m, n, k, a.dtype)
        other = ALL_SK if s.policy.kind == PolicyKind.DP else DP

        def kernel(pol, a=a, b=b, s=s):
            return gemm_grouped_streamk(a, b, policy=pol, cfg=s.cfg, g=s.g)

        plain = gemm_grouped_streamk_plain(a, b, sizes=(m,) * gc, out_dtype=a.dtype)
        err = max(close(kernel(s.policy), plain, 2e-2, f"B5 timing {gc}x{m}x{n}x{k}"),
                  close(kernel(other), plain, 2e-2, f"B5 timing {gc}x{m}x{n}x{k} other"))
        ms, ev = time_ms(lambda: kernel(s.policy))
        other_ms, other_ev = time_ms(lambda: kernel(other))
        plain_ms, plain_ev = time_ms(
            lambda: gemm_grouped_streamk_plain(a, b, sizes=(m,) * gc, out_dtype=a.dtype), iters=3)
        lib, lib_ev = time_ms(lambda: torch.bmm(a, b))
        bnd, by = bound_ms((gc * m * k + gc * k * n + gc * m * n) * 2, 2 * gc * m * n * k)
        rows.append(dict(
            shape=[gc, m, n, k], kernel=_grouped_kernel_name(s.policy), policy=s.policy.name,
            tile=s.cfg.name, g=s.g, max_abs_err=err, ms=ms, event_ms=ev,
            other_kernel=_grouped_kernel_name(other), other_policy=other.name, other_ms=other_ms,
            other_event_ms=other_ev,
            plain_ms=plain_ms, plain_event_ms=plain_ev, library_ms=lib, library_event_ms=lib_ev,
            bound_ms=bnd, bound_by=by))
        log(f"  B5 {gc}x{m}x{n}x{k} {s.policy.name}/{s.cfg.name} g={s.g}: device {ms:.4f} ms, "
            f"events {ev:.4f} ms; {other.name} {other_ms:.4f} ms; plain {plain_ms:.4f} ms; "
            f"torch.bmm {lib:.4f} ms; bound {bnd:.4f} ms by {by}")
    return rows


#: B5's device ms on the SIMT mainloop, before the bf16-activation rungs moved to
#: csrc/mma_bf16.cuh, as this script timed them on an NVIDIA H100 80GB HBM3 at 700 W, by
#: (kernel, pair): B5a at 64x16x1024x2048 (ALL_SK 16x128x128, g 132), B5b at
#: 64x4x1024x2048 (DP 8x256x128, g 132)
B5_SIMT_MS = {
    ("grouped_streamk_sk", "bf16"): 0.3070, ("grouped_streamk_sk", "int8"): 0.3687,
    ("grouped_streamk_sk", "int4"): 0.3436, ("grouped_streamk_dp", "bf16"): 0.2304,
    ("grouped_streamk_dp", "int8"): 0.3551, ("grouped_streamk_dp", "int4"): 0.2700,
}
B5_TABLE_SHAPES = {"grouped_streamk_sk": [64, 16, 1024, 2048],
                   "grouped_streamk_dp": [64, 4, 1024, 2048]}


def b5_table(grouped_rows, quant_rows):
    """Log B5's bf16-activation rungs in both forms at the kernel table's
    shapes: this run's device ms beside the SIMT mainloop's (``B5_SIMT_MS``),
    the bound and ``torch.bmm``; returns the rows."""
    import torch

    from repro_torch.kernels.common import mainloop

    rows = []
    log("B5, bf16 activations (device ms; the SIMT mainloop's in brackets), bound, torch.bmm:")
    log("| kernel | shape | bf16 | bf16 x int8 | bf16 x int4 | bound (bf16 / int8 / int4) | "
        "torch.bmm | mainloop |")
    for name, shape in B5_TABLE_SHAPES.items():
        dense = next(r for r in grouped_rows if r["shape"] == shape)
        ms = {"bf16": dense["ms"] if dense["kernel"] == name else dense["other_ms"]}
        bound = {"bf16": dense["bound_ms"]}
        for rung in ("int8", "int4"):
            row = next(r for r in quant_rows if r["kernel"] == name and r["rung"] == rung
                       and r["shape"] == shape)
            ms[rung], bound[rung] = row["ms"], row["bound_ms"]
        cells = " | ".join(f"{ms[p]:.4f} ({B5_SIMT_MS[name, p]:.4f})" for p in ms)
        log(f"| {'B5a' if name.endswith('sk') else 'B5b'} {name} | {'x'.join(map(str, shape))} "
            f"| {cells} | {' / '.join(f'{bound[p]:.4f}' for p in bound)} | "
            f"{dense['library_ms']:.4f} | {mainloop(name, torch.bfloat16)} |")
        rows.append(dict(kernel=name, shape=shape, ms=ms, simt_ms={
            p: B5_SIMT_MS[name, p] for p in ms}, bound_ms=bound,
            library_ms=dense["library_ms"], mainloop=mainloop(name, torch.bfloat16)))
    return rows


#: B5's device ms on its int8-activation rungs on the SIMT mainloop, before they moved to
#: csrc/mma_s8.cuh, as this script timed them on an NVIDIA H100 80GB HBM3 at 700 W (the kernel
#: table of PERF.md), by (kernel, rung), at the shapes of B5_TABLE_SHAPES: int8-dynamic is
#: int8 x int8, int4-dynamic int8 x packed int4
B5_S8_SIMT_MS = {
    ("grouped_streamk_sk", "int8-dynamic"): 0.31291,
    ("grouped_streamk_sk", "int4-dynamic"): 0.32485,
    ("grouped_streamk_dp", "int8-dynamic"): 0.26808,
    ("grouped_streamk_dp", "int4-dynamic"): 0.29148,
}


def b5_s8_table(quant_rows):
    """Log B5's int8-activation rungs (int8-dynamic and int4-dynamic) in
    both forms at the kernel table's shapes: this run's device ms beside the
    SIMT mainloop's (``B5_S8_SIMT_MS``), the bound and ``torch.bmm`` on the
    dequantized bf16 weight; returns the rows."""
    import torch

    from repro_torch.kernels.common import mainloop

    rows = []
    log("B5, int8 activations (device ms; the SIMT mainloop's in brackets), bound, torch.bmm:")
    log("| kernel | shape | int8-dynamic | int4-dynamic | bound (int8-dyn / int4-dyn) | "
        "torch.bmm (int8-dyn / int4-dyn) | mainloop |")
    for name, shape in B5_TABLE_SHAPES.items():
        ms, bound, lib = {}, {}, {}
        for rung in ("int8-dynamic", "int4-dynamic"):
            row = next(r for r in quant_rows if r["kernel"] == name and r["rung"] == rung
                       and r["shape"] == shape)
            ms[rung], bound[rung], lib[rung] = row["ms"], row["bound_ms"], row["library_ms"]
        cells = " | ".join(f"{ms[p]:.5f} ({B5_S8_SIMT_MS[name, p]:.5f})" for p in ms)
        log(f"| {'B5a' if name.endswith('sk') else 'B5b'} {name} | {'x'.join(map(str, shape))} "
            f"| {cells} | {' / '.join(f'{bound[p]:.5f}' for p in bound)} | "
            f"{' / '.join(f'{lib[p]:.4f}' for p in lib)} | {mainloop(name, torch.int8)} |")
        rows.append(dict(kernel=name, shape=shape, ms=ms, simt_ms={
            p: B5_S8_SIMT_MS[name, p] for p in ms}, bound_ms=bound, library_ms=lib,
            mainloop=mainloop(name, torch.int8)))
    return rows


#: B1's and B2+B3's device ms on the SIMT mainloop, before the bf16-activation rungs moved to
#: csrc/mma_bf16.cuh, as this script timed them on an NVIDIA H100 80GB HBM3 at 700 W (the
#: kernel table of PERF.md), by (kernel, pair): B1 at 4x14336x4096 (DP 8x128x128, g 132); B2+B3
#: at 4x4096x14336 (ALL_SK 8x256x128, g 132), for bf16 the composed call, for int8 and int4
#: B2's and B3's times added (their composed calls were not recorded)
B12_SIMT_MS = {
    ("dp_gemm_region", "bf16"): 0.11404, ("dp_gemm_region", "int8"): 0.17706,
    ("dp_gemm_region", "int4"): 0.13379, ("streamk_phase1", "bf16"): 0.1160,
    ("streamk_phase1", "int8"): 0.17522, ("streamk_phase1", "int4"): 0.11983,
}


def b12_table(timed, quant_rows):
    """Log B1 and the B2+B3 composition (one launch: B3 is fused into B2)
    on the bf16-activation rungs at the decode shapes of the kernel table:
    this run's device ms beside the SIMT mainloop's (``B12_SIMT_MS``), the
    bound and the library call; returns the rows."""
    import torch

    from repro_torch.kernels.common import mainloop

    rows = []
    log("B1 and B2+B3, bf16 activations at M = 4 (device ms; the SIMT mainloop's in "
        "brackets), bound, library:")
    log("| kernel | shape | bf16 | bf16 x int8 | bf16 x int4 | bound (bf16 / int8 / int4) | "
        "library (bf16 / int8 / int4) | mainloop |")
    for name in ("dp_gemm_region", "streamk_phase1"):
        dense = timed[name]
        rung_rows = {rung: next(r for r in quant_rows if r["kernel"] == name
                                and r["rung"] == rung and r["shape"][0] == N_SLOTS)
                     for rung in ("int8", "int4")}
        bound = {"bf16": dense["bound_ms"],
                 **{r: row["bound_ms"] for r, row in rung_rows.items()}}
        if name == "dp_gemm_region":
            ms = {"bf16": dense["ms"], **{r: row["ms"] for r, row in rung_rows.items()}}
            label = "B1 dp_gemm_region"
        else:
            ms = {"bf16": dense["composed_ms"],
                  **{r: row["composed_ms"] for r, row in rung_rows.items()}}
            label = "B2+B3 streamk_phase1 (B3 fused)"
        lib = {"bf16": dense["library_ms"],
               **{r: row["library_ms"] for r, row in rung_rows.items()}}
        cells = " | ".join(f"{ms[p]:.4f} ({B12_SIMT_MS[name, p]:.4f})" for p in ms)
        log(f"| {label} | {'x'.join(map(str, dense['shape']))} | {cells} | "
            f"{' / '.join(f'{bound[p]:.4f}' for p in bound)} | "
            f"{' / '.join(f'{lib[p]:.4f}' for p in lib)} | {mainloop(name, torch.bfloat16)} |")
        rows.append(dict(kernel=label, shape=dense["shape"], ms=ms,
                         simt_ms={p: B12_SIMT_MS[name, p] for p in ms}, bound_ms=bound,
                         library_ms=lib, mainloop=mainloop(name, torch.bfloat16)))
    return rows


#: B1's and B2+B3's device ms on their int8-activation rungs on the SIMT mainloop, before they
#: moved to csrc/mma_s8.cuh, as this script timed them on an NVIDIA H100 80GB HBM3 at 700 W
#: (the kernel table of PERF.md), by (kernel, rung), at B12_SIMT_MS's shapes: int8-dynamic is
#: int8 x int8, int4-dynamic int8 x packed int4; for B2+B3 B2's and B3's times added, as
#: B12_SIMT_MS has them
B12_S8_SIMT_MS = {
    ("dp_gemm_region", "int8-dynamic"): 0.11290,
    ("dp_gemm_region", "int4-dynamic"): 0.14803,
    ("streamk_phase1", "int8-dynamic"): 0.11550 + 0.00748,
    ("streamk_phase1", "int4-dynamic"): 0.11401 + 0.00748,
}


def b12_s8_table(quant_rows):
    """Log B1 and the B2+B3 composition (one launch: B3 is fused into B2)
    on the int8-activation rungs (int8-dynamic and int4-dynamic) at the
    decode shapes of the kernel table: this run's device ms beside the SIMT
    mainloop's (``B12_S8_SIMT_MS``), the bound, the rung's
    library yardstick (``torch._int_mm`` for int8-dynamic, ``torch.matmul``
    on the dequantized bf16 weight for int4-dynamic) and ``torch.matmul`` on
    the dequantized bf16 weight for both (the int8 rung's yardstick, timed
    at the same shape); returns the rows."""
    import torch

    from repro_torch.kernels.common import mainloop

    rungs = ("int8-dynamic", "int4-dynamic")
    rows = []
    log("B1 and B2+B3, int8 activations at M = 4 (device ms; the SIMT mainloop's in "
        "brackets), bound, library:")
    log("| kernel | shape | int8-dynamic | int4-dynamic | bound (int8-dyn / int4-dyn) | "
        "library (int8-dyn / int4-dyn) | torch.matmul, dequantized | mainloop |")

    def decode_row(name, rung):
        return next(r for r in quant_rows if r["kernel"] == name and r["rung"] == rung
                    and r["shape"][0] == N_SLOTS)

    for name in ("dp_gemm_region", "streamk_phase1"):
        own = {rung: decode_row(name, rung) for rung in rungs}
        bound = {r: row["bound_ms"] for r, row in own.items()}
        if name == "dp_gemm_region":
            ms = {r: row["ms"] for r, row in own.items()}
            label = "B1 dp_gemm_region"
        else:
            ms = {r: row["composed_ms"] for r, row in own.items()}
            label = "B2+B3 streamk_phase1 (B3 fused)"
        lib = {r: row["library_ms"] for r, row in own.items()}
        dense_lib = decode_row(name, "int8")["library_ms"]
        shape = own[rungs[0]]["shape"]
        cells = " | ".join(f"{ms[p]:.5f} ({B12_S8_SIMT_MS[name, p]:.5f})" for p in ms)
        log(f"| {label} | {'x'.join(map(str, shape))} | {cells} | "
            f"{' / '.join(f'{bound[p]:.5f}' for p in bound)} | "
            f"{' / '.join(f'{lib[p]:.4f}' for p in lib)} | {dense_lib:.4f} | "
            f"{mainloop(name, torch.int8)} |")
        rows.append(dict(kernel=label, shape=shape, ms=ms,
                         simt_ms={p: B12_S8_SIMT_MS[name, p] for p in ms}, bound_ms=bound,
                         library_ms=lib, dequantized_matmul_ms=dense_lib,
                         mainloop=mainloop(name, torch.int8)))
    return rows


#: the f32 table's GEMMs: (label, kernel, shape, policy name, tile) at g = 132, the kernel
#: table's decode shapes; and olmoe-1b-7b's router (4 x 2048 -> 64), the f32 GEMM that
#: every olmoe rung serves, under the H100 selector's pick (policy None)
F32_TABLE = (("B1", "dp_gemm_region", (4, 14336, 4096), "dp", (8, 128, 128)),
             ("B2+B3", "streamk_phase1", (4, 4096, 14336), "all_sk", (8, 256, 128)),
             ("B2+B3 router", "streamk_phase1", (4, 64, 2048), None, None),
             ("B5a", "grouped_streamk_sk", (64, 16, 1024, 2048), "all_sk", (16, 128, 128)),
             ("B5b", "grouped_streamk_dp", (64, 4, 1024, 2048), "dp", (8, 256, 128)))
#: the f32-activation pairs of the f32 table, as (pair, weight bits or None for f32): the
#: router is timed on f32 alone, the GEMM every olmoe rung serves
F32_PAIRS = (("f32", None), ("f32*int8", 8), ("f32*int4", 4))


def f32_table(gen):
    """B1, the B2+B3 composition (one launch) and both B5 forms on f32
    activations, with f32, int8 and packed int4 weights (the f32 FMA
    mainloop of ``csrc/fma_f32.cuh``) at
    ``F32_TABLE``'s shapes: device ms beside ``torch.matmul`` or
    ``torch.bmm`` in f32 (TF32 off; on the dequantized weight for the
    quantized pairs) and the bound (bytes over 3.35 TB/s or operations over
    67 TFLOP/s: A and C in f32, B at 4, 1 or 0.5 bytes a weight plus its f32
    scales; B2+B3: the split tiles' partials written and read back too),
    each call first held against that library call at the f32 tolerance,
    1e-4, and B1's and B2's also against their plain versions
    (``dp_gemm_region_plain``; ``streamk_phase1_plain`` on the split tiles'
    contributor slots) at 1e-4; each row's plain version (B2+B3:
    ``streamk_phase1_plain`` then ``streamk_fixup_plain``; B5:
    ``gemm_grouped_streamk_plain``) timed beside it; returns the rows."""
    import torch

    from repro_torch.core.op import GemmOp
    from repro_torch.core.policies import ALL_POLICIES, TileConfig
    from repro_torch.core.quant import quantize_weight
    from repro_torch.core.selector import default_selector
    from repro_torch.core.workpart import GemmShape, partition
    from repro_torch.kernels.common import mainloop
    from repro_torch.kernels.dp.dp_gemm import dp_gemm_region, dp_gemm_region_plain
    from repro_torch.kernels.streamk import ops as sk_ops
    from repro_torch.kernels.streamk.grouped import (
        gemm_grouped_streamk,
        gemm_grouped_streamk_plain,
    )
    from repro_torch.kernels.streamk.streamk_gemm import (
        streamk_fixup_plain,
        streamk_phase1_plain,
        streamk_region,
    )

    policies = {p.name: p for p in ALL_POLICIES}
    rows = []
    it = iter(range(10**9))
    log("B1, B2+B3 and B5, f32 activations (device ms), bound, torch.matmul / torch.bmm in f32 "
        "(quantized pairs: on the dequantized weight):")
    log("| kernel | pair | shape | policy / tile, g | ms | bound (by) | plain | library | "
        "mainloop |")
    for label, name, shape, pol, tile in F32_TABLE:
        *lead, m, n, k = shape
        if pol is None:
            s = default_selector("cuda").select_op(
                GemmOp.plain(m, n, k, in_dtype="float32", out_dtype="float32"))
            policy, cfg, grid = s.policy, s.cfg, s.g
        else:
            policy, cfg, grid = policies[pol], TileConfig(*tile), 132
        a = torch.randn(*lead, m, k, generator=gen, device="cuda")
        w = torch.randn(*lead, k, n, generator=gen, device="cuda") / math.sqrt(k)
        groups = lead[0] if lead else 1
        c = torch.empty(m, n, device="cuda") if name == "dp_gemm_region" else None
        library = torch.bmm if lead else torch.matmul
        for pair, bits in F32_PAIRS[:1] if pol is None else F32_PAIRS:
            if bits is None:
                b, w_lib, kw, b_bytes = w, w, {}, 4
            else:
                q = quantize_weight(w, bits=bits)
                b, w_lib = q.values, q.dequantize()
                kw, b_bytes = dict(scale=q.scales, b_bits=bits), bits / 8
            bs = _rotating(b)
            ws = _rotating(w_lib)

            def kernel(b, a=a, c=c, name=name, policy=policy, cfg=cfg, grid=grid, kw=kw):
                if name == "dp_gemm_region":
                    return dp_gemm_region(a, b, cfg, c=c, g=grid, **kw)
                if name == "streamk_phase1":
                    return sk_ops.gemm(a, b, policy=policy, cfg=cfg, g=grid,
                                       out_dtype=torch.float32, **kw)
                return gemm_grouped_streamk(a, b, policy=policy, cfg=cfg, g=grid,
                                            out_dtype=torch.float32, **kw)

            def plain(b=bs[0], a=a, name=name, cfg=cfg, kw=kw):
                if name == "dp_gemm_region":
                    return dp_gemm_region_plain(a, b, cfg, torch.empty(m, n, device="cuda"), **kw)
                if name == "streamk_phase1":  # the plain ALL_SK composition: B2, then B3
                    return streamk_fixup_plain(
                        streamk_phase1_plain(a, b, part, b_bits=kw.get("b_bits", 8)), part,
                        torch.empty(m, n, device="cuda"), scale=kw.get("scale"))
                return gemm_grouped_streamk_plain(a, b, sizes=(m,) * groups,
                                                  out_dtype=torch.float32, bk=cfg.bk, **kw)

            err = close(kernel(bs[0]), library(a, ws[0]), 1e-4, f"{label} {pair} f32 table")
            plain_err = None
            if name == "dp_gemm_region":
                plain_err = close(dp_gemm_region(a, bs[0], cfg, c=c, g=grid, **kw),
                                  dp_gemm_region_plain(a, bs[0], cfg, torch.empty_like(c), **kw),
                                  1e-4, f"{label} {pair} against its plain version")
            if name == "streamk_phase1":
                part = partition(GemmShape(m, n, k), cfg, grid, policy)
            if name == "streamk_phase1" and part.sk_tiles:
                b_bits = kw.get("b_bits", 8)
                _, partials = streamk_region(a, bs[0], part, torch.empty(m, n, device="cuda"),
                                             b_bits=b_bits, workspace=True)
                used = _used_slots(partials, part)[:, :, 0, 0]
                plain_err = close(partials[used],
                                  streamk_phase1_plain(a, bs[0], part, b_bits=b_bits)[used],
                                  1e-4, f"{label} {pair} B2 against its plain version"
                                  ) if used.any() else 0.0
            if name == "streamk_phase1" and part.dp_tiles:
                raise AssertionError(f"{label}: the plain composition times ALL_SK alone, "
                                     f"not {policy.name}")
            ms = time_ms(lambda: kernel(bs[next(it) % len(bs)]))[0]
            lib = time_ms(lambda: library(a, ws[next(it) % len(ws)]))[0]
            plain_ms = time_ms(plain)[0]
            scale_bytes = 0 if bits is None else groups * n * 4
            if name == "streamk_phase1":
                bnd, by = bound_ms(*_sk_region_bytes_ops(part, m, n, k, 4, b_bytes, 4,
                                                         scale_bytes), PEAK_F32)
            else:
                bnd, by = bound_ms(groups * (m * k * 4 + k * n * b_bytes + m * n * 4)
                                   + scale_bytes, 2 * groups * m * n * k, PEAK_F32)
            log(f"| {label} {name} | {pair} | {'x'.join(map(str, shape))} | {policy.name} / "
                f"{cfg.name}, {grid} | {ms:.5f} | {bnd:.5f} ({by}) | {plain_ms:.4f} | {lib:.5f} | "
                f"{mainloop(name, torch.float32)} |")
            rows.append(dict(kernel=label, name=name, pair=pair, shape=list(shape),
                             policy=policy.name, tile=cfg.name, g=grid, max_abs_err=err,
                             plain_max_abs_err=plain_err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bnd, bound_by=by, library_ms=lib,
                             library_of=library.__name__ + ("" if bits is None
                                                            else " on the dequantized weight"),
                             mainloop=mainloop(name, torch.float32)))
            del bs, ws
    return rows


def grouped_entry(rows, name):
    """The timing of kernel ``name`` for the kernels line: at the first
    shape where the H100 picks it, else the first where it ran as the other
    form."""
    for row in rows:
        if row["kernel"] == name:
            return dict(row)
    for row in rows:
        if row["other_kernel"] == name:
            return dict(row, kernel=name, policy=row["other_policy"], ms=row["other_ms"],
                        event_ms=row["other_event_ms"])
    raise AssertionError(f"{name} was never timed")


# ---------------------------------------------------------------------------
# Phase 2c: the quantization ladder, B1, B2 (B3 fused) and B5 on int8 and int4 weights
# ---------------------------------------------------------------------------


def _quant_operands(m, n, k, pair, gen, lead=()):
    """One operand pair of the ladder on the card: (a, b values, quantized
    kwargs, a_ref, w_ref, out dtype, tol). The weight is quantized per
    output channel (``quantize_weight``); int8 activations per row with
    their scales. ``a_ref @ w_ref`` is the dequantize-then-matmul reference
    in f32."""
    import torch

    from repro_torch.core.quant import quantize_activations, quantize_weight

    _, act, bits, act_q, tol = pair
    a = torch.randn(*lead, m, k, generator=gen, device="cuda").to(getattr(torch, act))
    q = quantize_weight(torch.randn(*lead, k, n, generator=gen, device="cuda") / math.sqrt(k),
                        bits=bits)
    kw = dict(scale=q.scales, b_bits=bits)
    a_ref = a.float()
    if act_q:
        a, kw["scale_a"] = quantize_activations(a)
        a_ref = a.float() * kw["scale_a"][..., None]
    return a, q.values, kw, a_ref, q.dequantize(), getattr(torch, act), tol


#: the quantized sweep's shapes: the dense sweep's, and one with an odd K (int4's zero pad
#: nibble) whose rows are not 16-byte aligned
QUANT_SWEEP_SHAPES = SWEEP_SHAPES + ((13, 400, 331),)


def quant_sweep(gen):
    """B1 and the Stream-K region (B2 with B3 fused in) on every pair of the
    ladder: all policies x g in {66, 132, 264} x epilogues {none, mul_silu,
    bias+gelu, square} at each quantized sweep shape, through ``ops.gemm`` against
    dequantize-then-matmul, and at g 66 and 132 each kernel on its own
    against its plain version (the split tiles' partials and the region's C
    against the plain sweep and fix-up, B1's C). The Stream-K composition
    is bitwise deterministic on every pair."""
    import torch

    from repro_torch.core.gemm import dtype_name
    from repro_torch.core.op import Epilogue, GemmOp
    from repro_torch.core.policies import ALL_POLICIES, ALL_SK
    from repro_torch.core.selector import default_selector
    from repro_torch.core.workpart import GemmShape, partition
    from repro_torch.kernels.dp.dp_gemm import dp_gemm_region, dp_gemm_region_plain
    from repro_torch.kernels.streamk import ops
    from repro_torch.kernels.streamk.streamk_gemm import (
        streamk_fixup_plain, streamk_phase1_plain, streamk_region,
    )

    errs = {}
    sel = default_selector("cuda")
    cases = bitwise = 0
    for (m, n, k), pair in ((shape, pair) for shape in QUANT_SWEEP_SHAPES for pair in QUANT_PAIRS):
        a, b, qkw, a_ref, w_ref, out, tol = _quant_operands(m, n, k, pair, gen)
        bits = qkw["b_bits"]
        scales = {key: v for key, v in qkw.items() if key != "b_bits"}
        in_dtype = f"{dtype_name(a.dtype)}*int{bits}"
        cfg = sel.select_op(GemmOp.plain(m, n, k, in_dtype=in_dtype,
                                         out_dtype=dtype_name(out))).cfg
        ref_acc = a_ref @ w_ref
        bias = torch.randn(n, generator=gen, device="cuda").to(out)
        operand = torch.randn(m, n, generator=gen, device="cuda").to(out)
        for epi_name, epi, kw in (
            ("none", Epilogue(), {}),
            ("mul_silu", Epilogue(binary="mul_silu"), {"operand": operand}),
            ("bias+gelu", Epilogue(activation="gelu", bias=True), {"bias": bias}),
            ("square", Epilogue(activation="square"), {}),  # nemotron-4-15b's MLP
        ):
            want = epi.apply(ref_acc, **kw).to(out)
            for pol in ALL_POLICIES:
                for g in (66, 132, 264):
                    what = f"{m}x{n}x{k} {pair[0]} {pol.name} g={g} {cfg.name} {epi_name}"
                    part = partition(GemmShape(m, n, k), cfg, g, pol)
                    c = ops.gemm(a, b, policy=pol, cfg=cfg, g=g, out_dtype=out, epilogue=epi,
                                 **qkw, **kw)
                    key = f"gemm {pair[0]}"
                    errs[key] = max(errs.get(key, 0.0), close(c, want, tol, what))
                    cases += 1
                    if g == 264:  # the composition only: the kernels are held at 66 and 132
                        continue
                    c_k = torch.zeros(m, n, dtype=out, device="cuda")
                    c_p = torch.zeros(m, n, dtype=out, device="cuda")
                    if part.sk_tiles:
                        _, p_k = streamk_region(a, b, part, c_k, epilogue=epi, b_bits=bits,
                                                workspace=True, **scales, **kw)
                        p_p = streamk_phase1_plain(a, b, part, b_bits=bits)
                        used = _used_slots(p_k, part)
                        streamk_fixup_plain(p_p, part, c_p, epilogue=epi, **scales, **kw)
                        key = f"streamk_phase1 {pair[0]}"
                        errs[key] = max(
                            errs.get(key, 0.0),
                            close(torch.where(used, p_k, 0.0), torch.where(used, p_p, 0.0), tol,
                                  what + " B2 slots"),
                            close(c_k, c_p, tol, what + " B2+B3"))
                    if part.dp_tiles:
                        dp_gemm_region(a, b, cfg, c=c_k, tile_offset=part.sk_tiles, g=g,
                                       epilogue=epi, **qkw, **kw)
                        dp_gemm_region_plain(a, b, cfg, c_p, tile_offset=part.sk_tiles,
                                             epilogue=epi, **qkw, **kw)
                        key = f"dp_gemm_region {pair[0]}"
                        errs[key] = max(errs.get(key, 0.0), close(c_k, c_p, tol, what + " B1"))
        runs = [ops.gemm(a, b, policy=ALL_SK, cfg=cfg, g=132, out_dtype=out, **qkw)
                for _ in range(2)]
        if not torch.equal(runs[0], runs[1]):
            raise AssertionError(f"{m}x{n}x{k} {pair[0]}: B2+B3 not bitwise deterministic")
        bitwise += 1
    torch.cuda.synchronize()
    return errs, cases, bitwise


#: the quantized grouped sweep's shapes: olmoe-1b-7b's expert shapes, the small unaligned
#: one, and the same with an odd K
QUANT_GROUPED_SHAPES = GROUPED_SHAPES + (GROUPED_RAGGED, GROUPED_RAGGED[:3] + (201,))


def quant_sweep_grouped(gen):
    """B5 on every pair of the ladder: every policy x g in {66, 132, 264} x
    epilogues {none, gelu, bias, mul_silu, square} x group sizes {full, ragged with
    empty groups}, against the plain version and the per-group
    dequantize-then-matmul reference; rows past a group's size stay 0; the
    Stream-K form with split tiles is bitwise deterministic."""
    import torch

    from repro_torch.core.op import Epilogue
    from repro_torch.core.policies import ALL_POLICIES, ALL_SK
    from repro_torch.kernels.streamk.grouped import (
        gemm_grouped_streamk, gemm_grouped_streamk_plain,
    )

    errs = {}
    cases = bitwise = 0
    rng = np.random.default_rng(2)
    for (gc, m, n, k), pair in ((shape, pair) for shape in QUANT_GROUPED_SHAPES
                                for pair in QUANT_PAIRS):
        a, b, qkw, a_ref, w_ref, out, tol = _quant_operands(m, n, k, pair, gen, lead=(gc,))
        cfg = grouped_pick(gc, m, n, k, out).cfg
        bias = torch.randn(gc, n, generator=gen, device="cuda").to(out)
        operand = torch.randn(gc, m, n, generator=gen, device="cuda").to(out)
        ragged = (0, m) + tuple(int(s) for s in rng.integers(0, m + 1, size=gc - 2))
        for sizes in ((m,) * gc, ragged):
            dead = (torch.arange(m, device="cuda")[None, :]
                    >= torch.tensor(sizes, device="cuda")[:, None])[:, :, None]
            for epi, kw in ((Epilogue(), {}), (Epilogue(activation="gelu"), {}),
                            (Epilogue(bias=True), {"bias": bias}),
                            (Epilogue(binary="mul_silu"), {"operand": operand}),
                            (Epilogue(activation="square"), {})):
                what = f"B5 {gc}x{m}x{n}x{k} {pair[0]} {cfg.name} {epi.name} sizes={sizes}"
                want = gemm_grouped_streamk_plain(a, b, sizes=sizes, out_dtype=out,
                                                  epilogue=epi, bk=cfg.bk, **qkw, **kw)
                ref = torch.zeros_like(want)
                for i, s in enumerate(sizes):
                    if s:
                        ref[i, :s] = epi.apply(
                            a_ref[i, :s] @ w_ref[i],
                            bias=None if "bias" not in kw else bias[i],
                            operand=None if "operand" not in kw else operand[i, :s],
                        ).to(out)
                close(want, ref, tol, what + " plain vs dequantize-then-matmul")
                for pol in ALL_POLICIES:
                    for g in (66, 132, 264):
                        got = gemm_grouped_streamk(a, b, policy=pol, cfg=cfg, g=g, out_dtype=out,
                                                   epilogue=epi, group_sizes=sizes, **qkw, **kw)
                        key = f"{_grouped_kernel_name(pol)} {pair[0]}"
                        label = f"{what} {pol.name} g={g}"
                        errs[key] = max(errs.get(key, 0.0), close(got, want, tol, label),
                                        close(got, ref, tol, label + " vs dequantize"))
                        if torch.where(dead, got, 0).abs().max().item() != 0:
                            raise AssertionError(f"{label}: rows past a group's size are not 0")
                        cases += 1
            for g in (66, 132, 264):
                if _splits_tiles(sizes, n, k, cfg, g):
                    c1, c2 = (gemm_grouped_streamk(a, b, policy=ALL_SK, cfg=cfg, g=g,
                                                   out_dtype=out, group_sizes=sizes, **qkw)
                              for _ in range(2))
                    if not torch.equal(c1, c2):
                        raise AssertionError(f"B5 {gc}x{m}x{n}x{k} {pair[0]} g={g}: the "
                                             "Stream-K form is not bitwise deterministic")
                    bitwise += 1
    torch.cuda.synchronize()
    if not bitwise:
        raise AssertionError("no quantized B5 case split a tile: the hand-off went untested")
    return errs, cases, bitwise


def _int_mm_yardstick(a, b):
    """``torch._int_mm`` for an int8 x int8 product, where its shape rules
    allow: (call, label). It takes more than 16 rows, so a decode M is
    padded to the smallest size it accepts; None when none does."""
    import torch

    m, k = a.shape
    tried = []
    for mp in sorted({max(m, 17), 24, 32, 64}):
        if mp < m:
            continue
        a_p = torch.zeros(mp, k, dtype=torch.int8, device=a.device)
        a_p[:m] = a
        for b_lay, lay in ((b, "row-major B"), (b.t().contiguous().t(), "column-major B")):
            try:
                torch._int_mm(a_p, b_lay)
            except RuntimeError as e:
                tried.append(f"M={mp} {lay}: {str(e).splitlines()[0][:120]}")
                continue
            pad = f", M padded {m} -> {mp}" if mp != m else ""
            return (lambda a_p=a_p, b_lay=b_lay: torch._int_mm(a_p, b_lay),
                    f"torch._int_mm ({lay}{pad})")
    log(f"  torch._int_mm refused every shape tried: {tried}")
    return None, None


def _quant_bound(m, n, k, gc, a_bytes, b_bytes, act_q, peak):
    """(bound ms, by) of one quantized GEMM (gc groups): each input read
    once (A, B at its width, the f32 scales), C written once in bf16."""
    nbytes = gc * (m * k * a_bytes + k * n * b_bytes + n * 4 + (m * 4 if act_q else 0)
                   + m * n * 2)
    return bound_ms(nbytes, 2 * gc * m * n * k, peak)


def time_quant(gen):
    """Each rung's kernels (the served rungs and int4-dynamic, int8 x int4)
    at the decode (M = 4) and prompt (M = 57) shapes of the served runs: B1
    at mlp.gate (N 14336, K 4096), B2 (with B3 fused in) at mlp.out (N
    4096, K 14336) and B5 at olmoe-1b-7b's expert shapes; device and event
    ms beside the
    plain version, the bound (the int8 and int4 widths of B) and a library
    yardstick: ``torch._int_mm`` for int8 x int8 B1 and B2, else
    ``torch.matmul``/``torch.bmm`` on the dequantized bf16 weight, a dense
    yardstick that reads 2 bytes per weight."""
    import torch

    from repro_torch.core.gemm import dtype_name
    from repro_torch.core.op import GemmOp
    from repro_torch.core.policies import ALL_SK, DP, PolicyKind
    from repro_torch.core.quant import quantize_activations, quantize_weight
    from repro_torch.core.selector import default_selector
    from repro_torch.core.workpart import GemmShape, partition
    from repro_torch.kernels.dp.dp_gemm import dp_gemm_region, dp_gemm_region_plain
    from repro_torch.kernels.streamk import ops as sk_ops
    from repro_torch.kernels.streamk.grouped import (
        gemm_grouped_streamk, gemm_grouped_streamk_plain,
    )
    from repro_torch.kernels.streamk.streamk_gemm import (
        streamk_fixup_plain, streamk_phase1_plain, streamk_region,
    )

    sel = default_selector("cuda")
    rows = []
    it = iter(range(10**9))
    for rung, (bits, act_bits, _) in TIMED_RUNGS.items():
        act_q = act_bits == 8
        a_bytes, b_bytes = (1 if act_q else 2), (0.5 if bits == 4 else 1)
        peak = PEAK_INT8 if act_q else PEAK_BF16
        in_dtype = f"{'int8' if act_q else 'bfloat16'}*int{bits}"

        def operands(m, n, k, lead=()):
            a = torch.randn(*lead, m, k, generator=gen, device="cuda").to(torch.bfloat16)
            q = quantize_weight(torch.randn(*lead, k, n, generator=gen, device="cuda")
                                / math.sqrt(k), bits=bits)
            kw = dict(scale=q.scales, b_bits=bits)
            a_dense = a
            if act_q:
                a, kw["scale_a"] = quantize_activations(a)
            return a, a_dense, q, kw

        def timed(name, shape, policy, cfg, g, kernel, plain, err, bnd, by, lib, lib_label,
                  plain_iters=3):
            ms, ev = time_ms(kernel)
            plain_ms, plain_ev = time_ms(plain, iters=plain_iters)
            lib_ms, lib_ev = time_ms(lib) if lib is not None else (None, None)
            rows.append(dict(kernel=name, rung=rung, shape=list(shape), policy=policy,
                             tile=cfg.name, g=g, max_abs_err=err, ms=ms, event_ms=ev,
                             plain_ms=plain_ms, plain_event_ms=plain_ev, bound_ms=bnd,
                             bound_by=by, library_ms=lib_ms, library_event_ms=lib_ev,
                             library_of=lib_label))
            log(f"  {name}[{rung}] {'x'.join(map(str, shape))} {policy}/{cfg.name} g={g}: "
                f"device {ms:.4f} ms, events {ev:.4f} ms; plain {plain_ms:.4f} ms; "
                f"{lib_label} {lib_ms if lib_ms is None else round(lib_ms, 5)} ms; "
                f"bound {bnd:.5f} ms by {by}")

        for m in (4, 57):
            # B1 at mlp.gate ------------------------------------------------------
            n, k = 14336, 4096
            a, a_dense, q, kw = operands(m, n, k)
            s = sel.select_op(GemmOp.plain(m, n, k, in_dtype=in_dtype, out_dtype="bfloat16"))
            pol = "dp" if s.policy.kind == PolicyKind.DP else f"dp (pick {s.policy.name})"
            c = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
            c_p = torch.empty_like(c)
            err = close(dp_gemm_region(a, q.values, s.cfg, c=c, g=s.g, **kw),
                        dp_gemm_region_plain(a, q.values, s.cfg, c_p, **kw), 2e-2,
                        f"B1[{rung}] timing")
            vs = _rotating(q.values)
            w_bf16 = q.dequantize(torch.bfloat16)
            if act_q and bits == 8:
                lib, label = _int_mm_yardstick(a, q.values)
            else:
                ws = _rotating(w_bf16)
                lib, label = (lambda: torch.matmul(a_dense, ws[next(it) % len(ws)]),
                              "torch.matmul on the dequantized bf16 weight (dense yardstick)")
            bnd, by = _quant_bound(m, n, k, 1, a_bytes, b_bytes, act_q, peak)
            timed("dp_gemm_region", (m, n, k), pol, s.cfg, s.g,
                  lambda: dp_gemm_region(a, vs[next(it) % len(vs)], s.cfg, c=c, g=s.g, **kw),
                  lambda: dp_gemm_region_plain(a, vs[next(it) % len(vs)], s.cfg, c_p, **kw),
                  err, bnd, by, lib, label)

            # B2 with B3 fused in, at mlp.out ---------------------------------------
            n, k = 4096, 14336
            a, a_dense, q, kw = operands(m, n, k)
            scales = {key: v for key, v in kw.items() if key != "b_bits"}
            s = sel.select_op(GemmOp.plain(m, n, k, in_dtype=in_dtype, out_dtype="bfloat16"))
            policy = s.policy if s.policy.is_streamk else ALL_SK
            part = partition(GemmShape(m, n, k), s.cfg, s.g, policy)
            if not part.sk_tiles:
                part, policy = partition(GemmShape(m, n, k), s.cfg, s.g, ALL_SK), ALL_SK
            pol = policy.name if policy == s.policy else f"{policy.name} (pick {s.policy.name})"
            c = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
            c_p = torch.empty_like(c)
            c_k, p_k = streamk_region(a, q.values, part, c, b_bits=bits, workspace=True,
                                      **scales)
            used = _used_slots(p_k, part)
            p_p = streamk_phase1_plain(a, q.values, part, b_bits=bits)
            err2 = max(close(torch.where(used, p_k, 0.0), torch.where(used, p_p, 0.0), 2e-2,
                             f"B2[{rung}] timing, split-tile slots"),
                       close(c_k, streamk_fixup_plain(p_p, part, c_p, **scales), 2e-2,
                             f"B2+B3[{rung}] timing"))
            vs = _rotating(q.values)
            if act_q and bits == 8:
                lib, label = _int_mm_yardstick(a, q.values)
                label = label and f"{label} of the whole GEMM (the ALL_SK region computes it)"
            else:
                ws = _rotating(q.dequantize(torch.bfloat16))
                lib, label = (lambda: torch.matmul(a_dense, ws[next(it) % len(ws)]),
                              "torch.matmul on the dequantized bf16 weight, the whole GEMM "
                              "(dense yardstick)")
            bnd, by = bound_ms(*_sk_region_bytes_ops(
                part, m, n, k, a_bytes, b_bytes, 2, n * 4 + (m * 4 if act_q else 0)), peak)
            timed("streamk_phase1", (m, n, k), pol, s.cfg, s.g,
                  lambda: streamk_region(a, vs[next(it) % len(vs)], part, c, b_bits=bits,
                                         **scales),
                  lambda: streamk_fixup_plain(streamk_phase1_plain(
                      a, vs[next(it) % len(vs)], part, b_bits=bits), part, c_p, **scales),
                  err2, bnd, by, lib, label, plain_iters=1)
            rows[-1]["composed_ms"] = time_ms(lambda: sk_ops.gemm(
                a, vs[next(it) % len(vs)], policy=policy, cfg=s.cfg, g=s.g,
                out_dtype=torch.bfloat16, **kw))[0]

        # B5 at olmoe-1b-7b's expert shapes, both forms -----------------------------
        for gc, m, n, k in GROUPED_SHAPES:
            a, a_dense, q, kw = operands(m, n, k, lead=(gc,))
            s = default_selector("cuda").select_op(GemmOp(
                m, n, k, g=gc, kind="grouped", in_dtype=in_dtype, out_dtype="bfloat16",
                fused=True))
            want = gemm_grouped_streamk_plain(a, q.values, sizes=(m,) * gc,
                                              out_dtype=torch.bfloat16, bk=s.cfg.bk, **kw)
            w_bf16 = q.dequantize(torch.bfloat16)
            bnd, by = _quant_bound(m, n, k, gc, a_bytes, b_bytes, act_q, peak)
            for form in (s.policy, ALL_SK if s.policy.kind == PolicyKind.DP else DP):
                err = close(gemm_grouped_streamk(a, q.values, policy=form, cfg=s.cfg, g=s.g,
                                                 out_dtype=torch.bfloat16, **kw), want, 2e-2,
                            f"B5[{rung}] timing {gc}x{m}x{n}x{k} {form.name}")
                pol = form.name if form == s.policy else f"{form.name} (pick {s.policy.name})"
                timed(_grouped_kernel_name(form), (gc, m, n, k), pol, s.cfg, s.g,
                      lambda form=form: gemm_grouped_streamk(
                          a, q.values, policy=form, cfg=s.cfg, g=s.g, out_dtype=torch.bfloat16,
                          **kw),
                      lambda: gemm_grouped_streamk_plain(a, q.values, sizes=(m,) * gc,
                                                         out_dtype=torch.bfloat16, bk=s.cfg.bk,
                                                         **kw),
                      err, bnd, by, lambda: torch.bmm(a_dense, w_bf16),
                      "torch.bmm on the dequantized bf16 weights (dense yardstick)",
                      plain_iters=1)
            del w_bf16
    return rows


def quant_entry(rows, name, rung):
    """The timing of ``name`` on ``rung`` for the kernels line: at the
    decode shape where the selector picks it (M = 4, or B5's first expert
    shape), else the first shape where it ran."""
    mine = [r for r in rows if r["kernel"] == name and r["rung"] == rung]
    picked = [r for r in mine if "pick" not in r["policy"]]
    return dict((picked or mine)[0])


# ---------------------------------------------------------------------------
# Phase 2d: B6, the split-K baseline; the baseline comparison; gemm_batched
# ---------------------------------------------------------------------------


#: B6's operand pairs: the dense ones, then the quantized sweep's (name, activation dtype,
#: weight bits or None, int8 activations, tolerance)
SPLITK_PAIRS = (("f32", "float32", None, False, 1e-4), ("bf16", "bfloat16", None, False, 2e-2),
                *QUANT_PAIRS)
#: B6's sweep shapes: the sweep shape, a ragged one whose rows are not 16-byte aligned, an odd
#: K (int4's zero pad nibble), and K = 200 below bk * s for s >= 2 (empty splits)
SPLITK_SHAPES = ((64, 4096, 4096), (17, 302, 520), (13, 400, 331), (9, 384, 200))
SPLITK_S = (1, 2, 4, 8)
SPLITK_G = (0, 66, 132, 264)


def _splitk_operands(m, n, k, pair, gen):
    """(a, b, quantized kwargs, a_ref @ w_ref in f32, out dtype, tol) of one B6 pair."""
    if pair[2] is None:
        import torch

        a, b, _, _ = _operands(m, n, k, getattr(torch, pair[1]), gen)
        return a, b, {}, a.float() @ b.float(), a.dtype, pair[4]
    a, b, qkw, a_ref, w_ref, out, tol = _quant_operands(m, n, k, pair, gen)
    return a, b, qkw, a_ref @ w_ref, out, tol


def splitk_sweep(gen):
    """B6 on every operand pair (dense f32 and bf16, the ladder's six) x s in
    {1, 2, 4, 8} x g in {0, 66, 132, 264} at each split-K shape: the
    partials against the plain version (empty splits must read 0), ``ops.gemm``
    (the sum over the splits, then the scales) against ``gemm_ref`` or
    dequantize-then-matmul; two runs bitwise identical per (shape, pair, s).
    A planted fault, a reduction that drops the last split, must read at
    least 3 times its limit. Also returns each pair's B6 launches."""
    import torch

    from repro_torch.core.gemm import dtype_name
    from repro_torch.core.op import GemmOp
    from repro_torch.core.selector import default_selector
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.splitk import ops as splitk_ops
    from repro_torch.kernels.splitk.splitk_gemm import (
        k_per_split, splitk_partials, splitk_partials_plain,
    )

    sel = default_selector("cuda")
    errs = {}
    cases = bitwise = empty = 0
    fault = None
    launches = dict.fromkeys((p[0] for p in SPLITK_PAIRS), 0)

    def b6_launches():
        return sum(v for key, v in LAUNCHES.items() if key.startswith("splitk_partials"))

    for (m, n, k), pair in ((shape, pair) for shape in SPLITK_SHAPES for pair in SPLITK_PAIRS):
        launches[pair[0]] -= b6_launches()
        a, b, qkw, ref_acc, out, tol = _splitk_operands(m, n, k, pair, gen)
        bits = qkw.get("b_bits", 8)
        in_dtype = f"{dtype_name(a.dtype)}*int{bits}" if qkw else dtype_name(a.dtype)
        cfg = sel.select_op(GemmOp.plain(m, n, k, in_dtype=in_dtype,
                                         out_dtype=dtype_name(out))).cfg
        want = ref_acc.to(out)
        for sp in SPLITK_S:
            plain = splitk_partials_plain(a, b, cfg, sp, b_bits=bits)
            first_empty = -(-k // (k_per_split(k, cfg.bk, sp) * cfg.bk))
            for g in SPLITK_G:
                what = f"B6 {m}x{n}x{k} {pair[0]} {cfg.name} s={sp} g={g}"
                parts = splitk_partials(a, b, cfg, sp, g=g, b_bits=bits)
                key = f"splitk_partials {pair[0]}"
                errs[key] = max(errs.get(key, 0.0), close(parts, plain, tol, what))
                if first_empty < sp:
                    if parts[first_empty:].any():
                        raise AssertionError(f"{what}: an empty split is not 0")
                    empty += 1
                c = splitk_ops.gemm(a, b, cfg=cfg, s=sp, g=g, out_dtype=out, **qkw)
                key = f"gemm {pair[0]}"
                errs[key] = max(errs.get(key, 0.0), close(c, want, tol, what + " ops.gemm"))
                cases += 1
            runs = [splitk_ops.gemm(a, b, cfg=cfg, s=sp, g=132, out_dtype=out, **qkw)
                    for _ in range(2)]
            if not torch.equal(runs[0], runs[1]):
                raise AssertionError(f"B6 {m}x{n}x{k} {pair[0]} s={sp}: not bitwise deterministic")
            bitwise += 1
        if fault is None and (m, n, k) == SPLITK_SHAPES[0] and pair[0] == "f32":
            # the planted fault: the reduction drops the last of 4 splits
            bad = splitk_partials(a, b, cfg, 4)[:-1].sum(dim=0)
            limit = tol * max(1.0, want.abs().max().item())
            fault = dict(max_abs_diff=(bad - want).abs().max().item(), limit=limit)
            if fault["max_abs_diff"] < 3 * limit:
                raise AssertionError(f"B6 planted fault reads {fault['max_abs_diff']:.4e}, under "
                                     f"3 x its limit {limit:.4e}")
        launches[pair[0]] += b6_launches()
    torch.cuda.synchronize()
    if not empty:
        raise AssertionError("no B6 case had an empty split")
    return errs, cases, bitwise, empty, fault, launches


#: split factors of the baseline comparison, and its prompt M: the first served prompt's
#: length, the prompt shape the quantized timings use too
COMPARE_S = (2, 4, 8)
PROMPT_M = 57


def baseline_comparison(gen):
    """The slice's main path: at granite-8b's five projection shapes, M = 4
    (decode) and 57 (the first served prompt), bf16, one GEMM each through
    the H100 selector's pick (the whole composition), ``dp.ops.gemm`` and
    ``splitk.ops.gemm`` at s in {2, 4, 8}, both with the pick's tile and one
    block per tile, checked against ``gemm_ref``. The launch counters are
    zeroed just before and read just after. Then each is timed (device ms,
    weights past L2) beside ``torch.matmul``. Returns (rows, launches)."""
    import torch

    from repro_torch.core.gemm import dtype_name
    from repro_torch.core.op import GemmOp
    from repro_torch.core.selector import default_selector
    from repro_torch.core.workpart import GemmShape, partition
    from repro_torch.kernels.common import LAUNCHES, reset_launch_counts
    from repro_torch.kernels.dp import ops as dp_ops
    from repro_torch.kernels.splitk import ops as splitk_ops
    from repro_torch.kernels.streamk import ops as sk_ops
    from repro_torch.kernels.streamk.ref import gemm_ref

    sel = default_selector("cuda")
    shapes = [(m, n, k) for m in (N_SLOTS, PROMPT_M) for n, k in SLICE_NK]
    cases = []
    for m, n, k in shapes:
        a, b, _, _ = _operands(m, n, k, torch.bfloat16, gen)
        s = sel.select_op(GemmOp.plain(m, n, k, in_dtype=dtype_name(a.dtype)))
        fns = {"pick": lambda a, b, s=s: sk_ops.gemm(a, b, policy=s.policy, cfg=s.cfg, g=s.g),
               "dp": lambda a, b, s=s: dp_ops.gemm(a, b, cfg=s.cfg)}
        for sp in COMPARE_S:
            fns[f"splitk_s{sp}"] = lambda a, b, s=s, sp=sp: splitk_ops.gemm(a, b, cfg=s.cfg, s=sp)
        cases.append((m, n, k, a, b, s, fns))
    torch.cuda.synchronize()
    reset_launch_counts()
    worst = 0.0
    for m, n, k, a, b, s, fns in cases:
        want = gemm_ref(a, b, torch.float32)
        for name, fn in fns.items():
            worst = max(worst, close(fn(a, b), want, 2e-2, f"compare {m}x{n}x{k} {name}"))
    torch.cuda.synchronize()
    launches = {name: n for name, n in LAUNCHES.items() if n}
    log(f"baseline comparison ({len(cases)} shapes): launches {launches}; max err {worst:.3e}")
    if launches.get("splitk_partials", 0) != len(cases) * len(COMPARE_S):
        raise AssertionError(f"expected {len(cases) * len(COMPARE_S)} B6 launches, got "
                             f"{launches.get('splitk_partials', 0)}")
    needed = {"dp_gemm_region"}  # the DP baseline
    for m, n, k, a, b, s, fns in cases:
        part = partition(GemmShape(m, n, k), s.cfg, s.g, s.policy)
        needed |= {"streamk_phase1"} if part.sk_tiles else set()
        needed |= {"dp_gemm_region"} if part.dp_tiles else set()
    missing = sorted(name for name in needed if not launches.get(name))
    if missing:
        raise AssertionError(f"the baseline comparison never launched {missing}")
    rows = []
    for m, n, k, a, b, s, fns in cases:
        bs = _rotating(b)
        it = iter(range(10**9))
        row = dict(shape=[m, n, k], policy=s.policy.name, tile=s.cfg.name, g=s.g)
        for name, fn in fns.items():
            row[f"{name}_ms"], row[f"{name}_event_ms"] = time_ms(
                lambda fn=fn: fn(a, bs[next(it) % len(bs)]))
        row["matmul_ms"], row["matmul_event_ms"] = time_ms(
            lambda: torch.matmul(a, bs[next(it) % len(bs)]))
        row["bound_ms"], row["bound_by"] = bound_ms((m * k + k * n + m * n) * 2, 2 * m * n * k)
        rows.append(row)
        log(f"  {m}x{n}x{k} pick {s.policy.name}/{s.cfg.name} g={s.g} {row['pick_ms']:.4f}, dp "
            f"{row['dp_ms']:.4f}, " + ", ".join(f"s={sp} {row[f'splitk_s{sp}_ms']:.4f}"
                                                for sp in COMPARE_S)
            + f", torch.matmul {row['matmul_ms']:.4f}, bound {row['bound_ms']:.4f} ms")
    return rows, launches, worst


def time_splitk(gen):
    """B6 at the decode shape 4x14336x4096 (mlp.gate), s = 4, the bf16
    pick's tile, one block per tile, on every operand pair: its partials
    against the plain version first (dequantized, times the scales the
    reduction applies after them: 2e-2 for bf16 activations, 1e-4 for f32
    and int8 ones; int8 activations bitwise), then device and event ms
    beside the plain version and a library call of the whole GEMM:
    ``torch.matmul`` in f32 for f32 activations (on the dequantized weight
    for the ladder's), else ``torch.matmul`` on the dequantized bf16 weight,
    and ``torch._int_mm`` too for int8 x int8. The bound reads A and B once
    at their widths (packed int4: K * N / 2 bytes) and writes the s * M * N
    f32 partials. Returns one row per pair."""
    import torch

    from repro_torch.core.gemm import dtype_name
    from repro_torch.core.op import GemmOp
    from repro_torch.core.selector import default_selector
    from repro_torch.kernels.common import mainloop, rung_of
    from repro_torch.kernels.splitk.splitk_gemm import splitk_partials, splitk_partials_plain

    m, n, k, sp = 4, 14336, 4096, 4
    cfg = default_selector("cuda").select_op(
        GemmOp.plain(m, n, k, in_dtype="bfloat16")).cfg
    rows = []
    it = iter(range(10**9))
    for pair in SPLITK_PAIRS:
        name, act, bits, act_q, tol = pair
        if bits is None:
            a, b, _, _ = _operands(m, n, k, getattr(torch, act), gen)
            a_lib, w_lib, dequant, b_bits = a, b, None, 8
        else:
            a, b, qkw, a_ref, w_ref, _, tol = _quant_operands(m, n, k, pair, gen)
            b_bits = bits
            dequant = qkw["scale"][None, :] * (qkw["scale_a"][:, None] if act_q else 1.0)
            lib_dtype = torch.float32 if act == "float32" and not act_q else torch.bfloat16
            a_lib, w_lib = a_ref.to(lib_dtype), w_ref.to(lib_dtype)
        what = f"B6 timing {m}x{n}x{k} {name} s={sp} {cfg.name}"
        got = splitk_partials(a, b, cfg, sp, b_bits=b_bits)
        want = splitk_partials_plain(a, b, cfg, sp, b_bits=b_bits)
        bitwise = bool(torch.equal(got, want))
        if act_q and not bitwise:
            raise AssertionError(f"{what}: int8-activation partials differ from the plain "
                                 f"version's bits")
        err = (close(got, want, tol, what) if dequant is None
               else close(got * dequant, want * dequant, tol, what))
        del got, want
        bs = _rotating(b)
        ms, ev = time_ms(lambda: splitk_partials(a, bs[next(it) % len(bs)], cfg, sp,
                                                 b_bits=b_bits))
        plain, plain_ev = time_ms(lambda: splitk_partials_plain(
            a, bs[next(it) % len(bs)], cfg, sp, b_bits=b_bits), iters=3 if act_q else 20)
        ws = _rotating(w_lib)
        lib, lib_ev = time_ms(lambda: torch.matmul(a_lib, ws[next(it) % len(ws)]))
        label = f"torch.matmul in {dtype_name(w_lib.dtype)} of the whole GEMM" + (
            "" if bits is None else " on the dequantized weight")
        row = dict(pair=name, rung=rung_of(a.dtype, b.dtype, b_bits),
                   mainloop=mainloop("splitk_partials", a.dtype), shape=[m, n, k],
                   policy=f"split-K s={sp}", tile=cfg.name, g=0, s=sp, max_abs_err=err,
                   bitwise=bitwise, ms=ms, event_ms=ev, plain_ms=plain, plain_event_ms=plain_ev,
                   library_ms=lib, library_event_ms=lib_ev, library_of=label)
        del ws
        if act_q and bits == 8:
            int_mm, int_label = _int_mm_yardstick(a, b)
            row["dense_library_ms"] = lib
            row["library_ms"], row["library_event_ms"] = (
                time_ms(int_mm) if int_mm is not None else (None, None))
            row["library_of"] = int_label and f"{int_label} of the whole GEMM"
        a_bytes = a.element_size()
        b_bytes = 0.5 if b_bits == 4 else b.element_size()
        peak = PEAK_INT8 if act_q else PEAK_F32 if act == "float32" else PEAK_BF16
        row["bound_ms"], row["bound_by"] = bound_ms(
            m * k * a_bytes + k * n * b_bytes + sp * m * n * 4, 2 * m * n * k, peak)
        rows.append(row)
        log(f"  B6 {m}x{n}x{k} s={sp} {cfg.name} {name} ({row['mainloop']}): device {ms:.5f} ms, "
            f"events {ev:.5f} ms; plain {plain:.4f} ms; {row['library_of']} "
            f"{row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 5)}"
            f" ms; bound {row['bound_ms']:.5f} ms by {row['bound_by']}; max err {err:.3e}"
            f"{', bitwise' if bitwise else ''}")
        del bs
    return rows


def batched_check(gen):
    """``gemm_batched`` through the ``cuda`` backend at B = 4, granite-8b's
    4096 -> 14336 at M = 4, f32, against ``torch.bmm``; the launches must be
    B times the pick's kernels (the loop form)."""
    import torch

    from repro_torch.core.gemm import gemm_batched, gemm_context
    from repro_torch.core.workpart import GemmShape, partition
    from repro_torch.kernels.common import count_launches

    nb, m, k, n = 4, N_SLOTS, 4096, 14336
    x = torch.randn(nb, m, k, generator=gen, device="cuda")
    w = torch.randn(nb, k, n, generator=gen, device="cuda") / math.sqrt(k)
    with count_launches() as launched, gemm_context(backend="cuda") as ctx:
        got = gemm_batched(x, w, tag="batched")
    torch.cuda.synchronize()
    [e] = ctx.log
    sel = e.selection
    part = partition(GemmShape(m, n, k), sel.cfg, sel.g, sel.policy)
    per = (["streamk_phase1"] if part.sk_tiles else []) + (
        ["dp_gemm_region"] if part.dp_tiles else [])
    if e.op.fused or e.op.kind != "batched" or len(e.op.key) != 7 or launched != per * nb:
        raise AssertionError(f"gemm_batched: key {e.op.key}, launches {launched}, expected "
                             f"{per} x {nb}")
    err = close(got, torch.bmm(x, w), 1e-4, "gemm_batched vs torch.bmm")
    log(f"gemm_batched {nb}x{m}x{n}x{k} f32: {sel.policy.name}/{sel.cfg.name} g={sel.g}, "
        f"launches {launched}, max err {err:.3e} against torch.bmm")
    return dict(shape=[nb, m, n, k], policy=sel.policy.name, tile=sel.cfg.name, g=sel.g,
                launches=launched, max_abs_err=err)


# ---------------------------------------------------------------------------
# Phase 3: serve granite-8b, then olmoe-1b-7b
# ---------------------------------------------------------------------------


#: the rung of a served op, by its input-dtype fingerprint (None: dense)
RUNG_OF = {"bfloat16*int8": "int8", "int8*int8": "int8-dynamic", "bfloat16*int4": "int4"}


def _kernels_of(entry):
    """The launch counters one logged selection calls for."""
    from repro_torch.core.workpart import GemmShape, partition
    from repro_torch.kernels.common import launch_name

    sel = entry.selection
    rung = RUNG_OF.get(entry.op.in_dtype)
    if entry.op.fused:
        return {launch_name(_grouped_kernel_name(sel.policy), rung)}
    part = partition(GemmShape(*entry.local_mnk), sel.cfg, sel.g, sel.policy)
    names = set()
    if part.sk_tiles:
        names.add(launch_name("streamk_phase1", rung))
    if part.dp_tiles:
        names.add(launch_name("dp_gemm_region", rung))
    return names


def _gemm_weight_bytes(model, params):
    """Bytes of the GEMM weights one decode step reads (a quantized one
    counts its values and scales): every stacked projection, router and
    expert of the decoder (not Mamba2's conv, not the norms), the hybrid's
    shared block once per layer that runs it, and the head, ``lm_head`` or,
    tied, the embedding table it reads (counted once). An encoder-decoder's
    step reads neither the encoder nor the cross-attention K/V projections
    (their K/V are cached at prefill)."""
    from repro_torch.core.quant import QUANT_WEIGHT_NAMES, is_quantized

    gemm_weights = QUANT_WEIGHT_NAMES | {"router"}  # the projections, and a MoE's router

    def nbytes(t):
        return t.nbytes if is_quantized(t) else t.numel() * t.element_size()

    def weights(tree, skip=frozenset()):
        total = 0
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                total += weights(leaf, frozenset({"wk", "wv"}) if key == "cross_attn" else skip)
            elif key in gemm_weights and key not in skip:
                total += nbytes(leaf)
        return total

    total = weights(params["dec_layers"] if "dec_layers" in params else params["layers"])
    if "shared_attn" in params:
        total += weights(params["shared_attn"]) * sum(model.layer_flags()["use_attn"])
    return total + nbytes(params["lm_head"] if "lm_head" in params else params["embed"])


def phase_serve(arch, failures, then=None):
    """Serve ``arch`` at full width on the ``cuda`` backend: dense bf16, then
    on each rung of the quantization ladder, quantized from the same bf16
    weights (each quantized tree freed before the next). ``then(model,
    params, runs)``, when given, runs last, on the bf16 weights. Returns the
    runs' records by rung ("dense" first); see the module docstring."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM

    cfg = get_config(arch)
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{arch} FULL: {n_params / 1e9:.3f} B parameters "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB on the card) in "
        f"{time.perf_counter() - t0:.1f}s")
    runs = {"dense": serve_run(arch, model, params, None, failures)}
    dense_logits = runs["dense"].pop("logits")
    for rung, (bits, act_bits, _) in RUNGS.items():
        t0 = time.perf_counter()
        qparams, n_quant, n_skipped = model.quantize_weights(params, bits=bits,
                                                             act_bits=act_bits)
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        log(f"{arch} {rung}: quantized {n_quant} weight leaves ({n_skipped} skipped) in "
            f"{quant_s:.1f}s; {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
        runs[rung] = serve_run(arch, model, qparams, rung, failures, dense_logits=dense_logits)
        runs[rung].update(quantize_s=quant_s, quantized_leaves=n_quant)
        runs[rung].pop("logits")
        del qparams
        gc.collect()
        torch.cuda.empty_cache()
    if then is not None:
        then(model, params, runs)
    return runs


def serve_run(arch, model, params, rung, failures, dense_logits=None, b1_fault=False):
    """One served run of ``model`` on ``params`` (dense when ``rung`` is
    None) with its checks: launch counts, logits against the ``torch``
    backend (a breach, dense or quantized, is appended to ``failures``, so
    every run reports before the script fails), a planted fault (with
    ``b1_fault``, on every GEMM with a DP region; see ``planted_fault_diff``),
    timings and the decode breakdown."""
    import torch

    from repro_torch.core.gemm import gemm_context
    from repro_torch.kernels.common import LAUNCHES, count_launches, reset_launch_counts
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = model.cfg
    label = arch if rung is None else f"{arch} [{rung}]"
    weight_bytes = _gemm_weight_bytes(model, params)
    n_slots, max_seq = N_SLOTS, MAX_SEQ
    tol = LOGITS_TOL[arch] if rung is None else QUANT_LOGITS_TOL[arch, rung]

    def make_engine():
        return ServeEngine(model, params, ServeConfig(n_slots=n_slots, max_seq=max_seq, eos=-1),
                           backend="cuda")

    engine = make_engine()
    _tap_logits(engine)  # phase 14: each decode step's logits, beside the eager run's
    prompts = serve_prompts(cfg.vocab_size)
    for p in prompts:
        engine.submit(p, max_new_tokens=8)

    reset_launch_counts()
    done = engine.run()
    torch.cuda.synchronize()
    launches = {name: n for name, n in LAUNCHES.items() if n}

    if len(done) != 4 or engine.exhausted:
        raise AssertionError(f"{label}: served {len(done)}/4 requests")
    for r in done:
        if len(r.out_tokens) != 8 or not all(0 <= t < cfg.vocab_size for t in r.out_tokens):
            raise AssertionError(f"{label} request {r.uid}: bad tokens {r.out_tokens}")
    needed = set()
    for e in engine.selection_log:
        needed |= _kernels_of(e)
    fingerprints = sorted({e.op.in_dtype for e in engine.selection_log})
    log(f"launches in the {label} serve run: {launches}; the selections call for "
        f"{sorted(needed)}; fingerprints {fingerprints}")
    if sum(launches.values()) <= 0:
        raise AssertionError(f"the {label} serve run launched no kernel")
    for name in needed:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{label}: {name} was selected but never launched")
    if rung is not None:
        unquantized = {e.tag for e in engine.selection_log
                       if RUNG_OF.get(e.op.in_dtype) != rung and e.tag != "moe.router"}
        if unquantized:
            raise AssertionError(f"{label}: {sorted(unquantized)} did not run on the rung")
    # each grouped dispatch that ran eagerly is one B5 launch, and each captured decode
    # step's B5 launches count once per replay (phase 14's replay accounting)
    grouped = b5_called_for(engine, label)
    b5 = sum(n for name, n in launches.items() if name.startswith("grouped_streamk"))
    if b5 != grouped:
        raise AssertionError(f"{label}: {b5} B5 launches for {grouped} grouped dispatches "
                             f"(the eager ones once, each captured step's once a replay)")
    # launches of one prefill and one decode step (outside the counted run)
    with count_launches() as pre:
        engine.prefill_logits(prompts[0])
    cur = torch.zeros(n_slots, dtype=torch.long, device="cuda")
    toks = torch.ones(n_slots, 1, dtype=torch.long, device="cuda")
    scratch_cache = model.init_cache(n_slots, max_seq, device="cuda")
    with count_launches() as dec, gemm_context(selector=engine.selector, backend="cuda") as dctx:
        model.decode_step(params, scratch_cache, toks, cur)
    b5_per_step = sum(1 for n in dec if n.startswith("grouped_streamk"))
    b5_captured = sorted({sum(1 for n in c.launches if n.startswith("grouped_streamk"))
                          for c in engine.decode.captured})
    if cfg.family == "moe" and (b5_per_step != 3 * cfg.n_layers
                                or b5_captured != [3 * cfg.n_layers]):
        raise AssertionError(f"{label}: {b5_per_step} B5 launches in an eager decode step, "
                             f"{b5_captured} in each captured one, expected {3 * cfg.n_layers}")
    # phase 14 (a) and (c): the served run against the same requests decoded eagerly
    compiled = graph_vs_eager(label, engine, {r.uid: r.out_tokens for r in done}, make_engine,
                              prompts, tol, failures, breakdown=True)

    # a warm decode step, broken down; the same step with the torch backend
    # (library matmuls) is the yardstick for the time outside the GEMMs
    def step():
        model.decode_step(params, scratch_cache, toks, cur)

    breakdown = {}
    for backend in ("cuda", "torch"):
        with gemm_context(selector=engine.selector, backend=backend):
            breakdown[backend] = decode_breakdown(step)
    del scratch_cache
    if breakdown["cuda"]["fixup_ms"]:
        raise AssertionError(f"{label}: a fix-up kernel ran in a traced decode step "
                             f"({breakdown['cuda']['fixup_ms']} ms)")
    for backend, bd in breakdown.items():
        log(f"{label} warm decode step, {backend} backend: {bd['step_ms']:.2f} ms wall, "
            f"{bd['enqueue_ms']:.2f} ms host enqueue, device busy {bd['device_busy_ms']} ms "
            f"(GEMM kernels {bd['gemm_kernels_ms']} ms), idle share {bd['idle_share']}")
        for name, ms in bd["top_kernels"]:
            log(f"    {ms:9.3f} ms  {name}")
    per = lambda log_: {n: log_.count(n) for n in sorted(set(log_))}  # noqa: E731

    # the first request's prefill logits against the torch backend; for a
    # MoE model, count the routing choices the two backends made differently
    # the dense MoE run holds its limit on the routing-replayed reading, with
    # the router GEMM checked on its own (see ROUTER_TOL); an SSM or hybrid
    # stack on the layer-replayed reading (see ``layer_replayed_diff``)
    hold_replayed = cfg.family == "moe" and rung is None
    hold_layers = cfg.family in ("ssm", "hybrid") and rung is None
    tokens = torch.as_tensor(prompts[0], device="cuda")[None]
    with routing_log(check_router=hold_replayed) as routes_cuda, \
            layer_trace(hold_layers) as layers_cuda:
        got = engine.prefill_logits(prompts[0])
    with routing_log() as routes_torch, gemm_context(backend="torch"):
        want, _ = model.prefill(params, tokens)
    flips = routing_flips(routes_cuda, routes_torch)
    if got.shape != (1, 1, cfg.vocab_size) or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: bad prefill logits {tuple(got.shape)}")
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    # a second reading for a MoE model: the torch backend takes the cuda run's
    # top-k experts, so what is left is the kernels' rounding without the
    # routing flips it causes (held for the dense run, reported on a rung)
    replayed = None
    if cfg.family == "moe":
        with routing_replay(routes_cuda), gemm_context(backend="torch"):
            want_r, _ = model.prefill(params, torch.as_tensor(prompts[0], device="cuda")[None])
        replayed = (got.float() - want_r.float()).abs().max().item()
        del want_r
    layer_readings = None
    if hold_layers:
        layer_readings = layer_replayed_diff(lambda: model.prefill(params, tokens)[0], layers_cuda,
                                             got)
    del layers_cuda
    held = replayed if hold_replayed else max(layer_readings) * scale if hold_layers else diff
    same_top = int(got.float().argmax()) == int(want.float().argmax())
    # the same check must catch a kernel that skips a K chunk: B1 under the
    # DP policy for the dense model, B5 for the MoE model; on a rung, every
    # DP and grouped GEMM of the rung; read as the limit is held
    fault, fault_replayed = planted_fault_diff(
        model, params, engine.selector, prompts[0], want, grouped=cfg.family == "moe",
        rung=rung, replay=hold_replayed, b1=b1_fault, layers=hold_layers)
    if hold_layers:
        fault_replayed *= scale  # the fault run's layer-replayed reading, on the logits' scale
    fault_held = fault_replayed if hold_replayed or hold_layers else fault
    breaches = []
    if held > tol * scale:
        what = ("with the cuda run's routing replayed" if hold_replayed else
                "each layer fed the cuda run's input" if hold_layers else "each routing alone")
        other = "" if replayed is None or hold_replayed else (
            f"; with the cuda run's routing replayed: max|diff| {replayed:.4f}")
        breaches.append(f"{label} prefill logits ({what}): max|diff| {held:.4f} > {tol} * "
                        f"{scale:.4f} (each routing alone: {diff:.4f}; routing flips: "
                        f"{flips}{other})")
    if hold_replayed and routes_cuda.router_err > ROUTER_TOL:
        breaches.append(f"{label}: router logits vs torch.matmul of the same input: max|err| "
                        f"{routes_cuda.router_err:.3e} > {ROUTER_TOL} x max(1, max|ref|)")
    if fault_held < 3 * tol * scale:
        breaches.append(f"{label}: a planted fault must read at least 3x the limit: max|diff| "
                        f"{fault_held:.4f} < 3 * {tol} * {scale:.4f}")
    failures.extend(breaches)
    # quantization error, reported and not limited: the rung's logits
    # against the dense bf16 run's on the same prompt
    vs_dense = None
    if dense_logits is not None:
        vs_dense = (got.float() - dense_logits.float()).abs().max().item()

    tm = engine.timing
    step_ms = tm["decode_s"] / max(tm["decode_steps"], 1) * 1e3
    floor_ms = weight_bytes / HBM_BW * 1e3
    st = engine.selector_stats
    picks = {}
    for e in engine.selection_log:
        s = e.selection
        g_part = f"G={e.op.g} " if e.op.kind == "grouped" else ""
        picks.setdefault(f"{e.tag} {g_part}{e.local_mnk} {e.op.in_dtype}",
                         f"{s.policy.name}/{s.cfg.name}/g{s.g}")
    serve = dict(
        arch=arch, rung=rung, fingerprints=fingerprints, logits=got,
        logits_vs_dense_max_abs_diff=vs_dense, breaches=breaches,
        requests=len(done), prompt_lens=[len(p) for p in prompts],
        prefill_tokens=tm["prefill_tokens"], prefill_s=tm["prefill_s"],
        prefill_tok_s=tm["prefill_tokens"] / tm["prefill_s"],
        decode_tokens=tm["decode_tokens"], decode_steps=tm["decode_steps"],
        decode_s=tm["decode_s"], decode_tok_s=tm["decode_tokens"] / tm["decode_s"],
        decode_step_ms=step_ms, decode_floor_ms=floor_ms, weight_bytes=weight_bytes,
        launches=launches, grouped_dispatches=grouped, launches_per_prefill=per(pre),
        grouped_g=sorted({e.op.g for e in engine.selection_log if e.op.fused}),
        square_dispatches=sum(1 for e in engine.selection_log
                              if e.op.epilogue.activation == "square"),
        prefill_len=len(prompts[0]), launches_per_decode_step=per(dec),
        dispatches_per_decode_step=len(dctx.log),
        decode_breakdown=breakdown, logits_max_abs_diff=diff, logits_max_abs=scale,
        logits_tol=tol, planted_fault_max_abs_diff=fault, same_argmax=same_top,
        routing_flips=flips, logits_replayed_routing_max_abs_diff=replayed,
        logits_held=("replayed_routing" if hold_replayed else
                     "replayed_layers" if hold_layers else "own_routing"),
        layer_replayed_readings=layer_readings,
        logits_held_max_abs_diff=held, planted_fault_held_max_abs_diff=fault_held,
        planted_fault_replayed_routing_max_abs_diff=fault_replayed,
        router_max_rel_err=routes_cuda.router_err if hold_replayed else None,
        selector=dict(lookups=st.lookups, cache_hits=st.cache_hits, fallbacks=st.fallbacks),
        tokens={r.uid: r.out_tokens for r in done}, picks=picks,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9, compiled=compiled,
        launches_per_captured_step=[len(c.launches) for c in engine.decode.captured],
    )
    log(f"{label} served 4/4: prefill {serve['prefill_tok_s']:.1f} tok/s, decode "
        f"{serve['decode_tok_s']:.1f} tok/s, decode step {step_ms:.2f} ms "
        f"(weight-read floor {floor_ms:.2f} ms)")
    log(f"launches per prefill ({len(prompts[0])} tokens): {serve['launches_per_prefill']}; "
        f"per decode step: {serve['launches_per_decode_step']} ({len(dctx.log)} GEMM "
        f"dispatches)")
    log(f"{label} prefill logits vs torch backend: max|diff| {diff:.4f} (max|logit| "
        f"{scale:.4f}, limit {tol * scale:.4f}), same argmax: {same_top}; planted fault "
        f"{fault:.4f}; routing flips {flips}; vs the dense bf16 run: {vs_dense}")
    if replayed is not None:
        held_by = (f"held at the limit {tol}; the router logits read "
                   f"{routes_cuda.router_err:.3e} of limit {ROUTER_TOL}; planted fault "
                   f"{fault_replayed:.4f}" if hold_replayed
                   else f"reported, the limit {tol} holds the first reading")
        log(f"{label} prefill logits vs the torch backend replaying the cuda run's top-"
            f"{cfg.top_k} choices: max|diff| {replayed:.4f} ({replayed / scale:.3e} x max|logit|;"
            f" {held_by})")
    if hold_layers:
        worst = int(np.argmax(layer_readings[:-1]))
        log(f"{label} prefill with each layer of the torch backend fed the cuda run's input to "
            f"that layer: max|diff| x max|output| per layer up to {layer_readings[worst]:.3e} "
            f"(layer {worst}), logits "
            f"{layer_readings[-1]:.3e}; held at the limit {tol} (the reading above, each backend "
            f"on its own input, {diff / scale:.3e}, is reported); planted fault "
            f"{fault_replayed / scale:.3e}")
    log(f"selector: {st.lookups} lookups, {st.cache_hits} cache hits, {st.fallbacks} cold picks")
    for key, val in sorted(picks.items()):
        log(f"  {key} -> {val}")
    return serve


@contextmanager
def layer_trace(enabled=True, replay=None):
    """Record, while the block runs, each decoder layer's input and output
    (``LM._block``) in call order under whatever backend is active; with
    ``replay``, an earlier trace, layer i runs on that trace's input to
    layer i in place of its own. Disabled, it records nothing."""
    from repro_torch.models.lm import LM

    trace = []
    if not enabled:
        yield trace
        return
    block = LM._block

    def recording(self, params, i, x, **kw):
        if replay is not None:
            x = replay[len(trace)][0]
        out = block(self, params, i, x, **kw)
        trace.append((x, out[0]))
        return out

    LM._block = recording
    try:
        yield trace
    finally:
        LM._block = block


def layer_replayed_diff(prefill, trace, got, backend="torch"):
    """The reading an SSM or hybrid stack holds its limit on: ``prefill``
    runs on the ``torch`` backend with each layer fed the input it had in
    ``trace``, the run that gave the logits ``got``. Returns each layer's
    max|diff| over its max|output|, then the logits' max|diff| over
    max|logit|: the kernels' rounding of every layer, without the growth
    the layers after it give it. Such a stack amplifies a layer's rounding
    about 5-7 times more than a dense stack of its depth (PERF.md §7), so
    the reading with each backend on its own input measures the stack and
    not the kernels; a fault in any layer still reads in full. ``backend``:
    the replay's (phase 12 replays the one-rank ``cuda`` run against the
    ranks')."""
    from repro_torch.core.gemm import gemm_context

    with layer_trace(replay=trace) as mine, gemm_context(backend=backend):
        want = prefill().float()
    rel = [((a[1].float() - b[1].float()).abs().max() / b[1].float().abs().max()).item()
           for a, b in zip(trace, mine)]
    return rel + [(got.float() - want).abs().max().item() / want.abs().max().item()]


#: layers of the int8-KV-cache phase: granite-8b at full width, its depth cut to 2
KV_INT8_LAYERS = 2


def phase_kv_int8():
    """granite-8b at full width and ``KV_INT8_LAYERS`` layers with
    ``kv_cache_dtype="int8"``, bf16, seeded weights: the engine serves the
    four prompts on the ``cuda`` backend (launch counters zeroed just
    before, read just after; every kernel the selections call for must have
    launched), the cache must be int8 with f32 scales, and the first
    prompt's prefill and two decode steps (fed the tokens the engine chose)
    must give logits within granite's ``LOGITS_TOL`` of the ``torch``
    backend. The same steps with the model-dtype cache are reported, not
    limited: that difference is the cache's quantization error."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.gemm import gemm_context
    from repro_torch.kernels.common import LAUNCHES, reset_launch_counts
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = dataclasses.replace(get_config("granite-8b"), n_layers=KV_INT8_LAYERS,
                              kv_cache_dtype="int8")
    model = LM(cfg)
    params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
    engine = ServeEngine(model, params, ServeConfig(n_slots=N_SLOTS, max_seq=MAX_SEQ, eos=-1),
                         backend="cuda")
    prompts = serve_prompts(cfg.vocab_size)
    for p in prompts:
        engine.submit(p, max_new_tokens=8)
    reset_launch_counts()
    done = sorted(engine.run(), key=lambda r: r.uid)
    torch.cuda.synchronize()
    launches = {name: n for name, n in LAUNCHES.items() if n}
    needed = set()
    for e in engine.selection_log:
        needed |= _kernels_of(e)
    log(f"int8 KV cache, granite-8b x {KV_INT8_LAYERS} layers: launches {launches}; the "
        f"selections call for {sorted(needed)}")
    if len(done) != 4 or any(len(r.out_tokens) != 8 for r in done):
        raise AssertionError(f"int8 KV cache: served {len(done)}/4 requests")
    missing = [name for name in needed if launches.get(name, 0) <= 0]
    if missing or not needed:
        raise AssertionError(f"int8 KV cache: {missing} selected but never launched")
    dtypes = {key: str(v.dtype) for key, v in engine.cache["attn"].items()}
    if dtypes != {"k": "torch.int8", "v": "torch.int8", "k_scale": "torch.float32",
                  "v_scale": "torch.float32"}:
        raise AssertionError(f"int8 KV cache: the cache is {dtypes}")

    prompt = torch.as_tensor(prompts[0], device="cuda")[None]
    feed = done[0].out_tokens[:2]

    def decode_logits(lm, backend):
        with gemm_context(selector=engine.selector, backend=backend):
            out, cache = lm.prefill(params, prompt, max_seq=MAX_SEQ)
            steps = []
            for i, tok in enumerate(feed):
                pos = torch.tensor([prompt.shape[1] + i], device="cuda")
                out, cache = lm.decode_step(params, cache, torch.tensor([[tok]], device="cuda"),
                                            pos)
                steps.append(out.float())
        return torch.stack(steps)

    got = decode_logits(model, "cuda")
    want = decode_logits(model, "torch")
    model_cache = decode_logits(LM(dataclasses.replace(cfg, kv_cache_dtype="model")), "cuda")
    if got.shape != (2, 1, 1, cfg.vocab_size) or not torch.isfinite(got).all():
        raise AssertionError(f"int8 KV cache: bad decode logits {tuple(got.shape)}")
    tol = LOGITS_TOL["granite-8b"]
    diff = (got - want).abs().max().item()
    scale = want.abs().max().item()
    vs_model = (got - model_cache).abs().max().item()
    log(f"int8 KV cache decode logits (2 steps) vs torch backend: max|diff| {diff:.4f} "
        f"(max|logit| {scale:.4f}, limit {tol * scale:.4f}); vs the model-dtype cache "
        f"{vs_model:.4f} ({vs_model / scale:.2e} x max|logit|, reported)")
    if diff > tol * scale:
        raise AssertionError(f"int8 KV cache: decode logits max|diff| {diff:.4f} > {tol} * "
                             f"{scale:.4f}")
    return dict(layers=KV_INT8_LAYERS, launches=launches, needed=sorted(needed),
                cache_dtypes=dtypes, logits_max_abs_diff=diff, logits_max_abs=scale,
                logits_tol=tol, vs_model_dtype_cache_max_abs_diff=vs_model)


#: the tune phase: top-k budget of the card's sweeps, and olmoe-1b-7b's depth there (full
#: width; two layers reach every fingerprint kind its 16 do)
TUNE_TOP_K, TUNE_OLMOE_LAYERS = 5, 2


def phase_tune(failures):
    """The tuning slice's main path on the card (see the module docstring,
    phase 4): online adaptation timing the hand-written kernels while
    granite-8b (full) and olmoe-1b-7b (full width, ``TUNE_OLMOE_LAYERS``
    layers) serve; the journal replayed, calibrated and sieved; granite-8b
    served again from that warm ``SelectorState``. Hard checks append to
    ``failures``. Returns the phase's record."""
    import dataclasses
    import tempfile
    from collections import Counter

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import costmodel
    from repro_torch.core.adaptive import AdaptiveConfig, AdaptiveTuner
    from repro_torch.core.calibrate import (
        MIN_RECORDS,
        CalibrationError,
        calibrate_db,
        key_dtypes,
        profile_key,
    )
    from repro_torch.core.gemm import gemm_context
    from repro_torch.core.op import GemmOp
    from repro_torch.core.policies import HOPPER_TILE_CONFIGS
    from repro_torch.core.selector import KernelSelector, SelectorState, default_selector
    from repro_torch.core.tuner import Tuner, TuningDatabase, _key_shape, measure_wallclock
    from repro_torch.kernels.common import LAUNCHES, reset_launch_counts
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    t_phase = time.perf_counter()
    h100 = costmodel.H100
    bf16 = profile_key(costmodel.profile_for("bfloat16"))
    granite = LM(get_config("granite-8b"))
    granite_params = granite.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
    prompts = serve_prompts(granite.cfg.vocab_size)
    tmp = tempfile.TemporaryDirectory()
    journal = str(Path(tmp.name) / "tune.jsonl")

    def engine_for(model, params, selector=None, adaptive=None):
        eng = ServeEngine(model, params, ServeConfig(n_slots=N_SLOTS, max_seq=MAX_SEQ, eos=-1),
                          backend="cuda", selector=selector, adaptive=adaptive,
                          adapt_every=1 if adaptive is not None else 0)
        for p in serve_prompts(model.cfg.vocab_size):
            eng.submit(p, max_new_tokens=8)
        return eng

    # 1. cold: every fingerprint misses once (hot_threshold=1), is timed on the kernels
    #    between decode steps (top-k budget) and journaled
    cold = TuningDatabase()
    selector = KernelSelector(mach=h100, tile_configs=HOPPER_TILE_CONFIGS,
                              state=SelectorState(db=cold, sieve=cold.build_sieve()))
    tuner = Tuner(policies=selector.policies, tile_configs=selector.tile_configs,
                  measure_fn=measure_wallclock(), mach=h100, grid_sizes=selector.grid_sizes,
                  top_k=TUNE_TOP_K)
    adaptive = AdaptiveTuner(selector, tuner=tuner, journal=journal,
                             config=AdaptiveConfig(hot_threshold=1, top_k=TUNE_TOP_K))
    served = {}
    t0 = time.perf_counter()
    eng = engine_for(granite, granite_params, adaptive=adaptive)
    done = eng.run()
    served["granite-8b"] = dict(requests=len(done), seconds=time.perf_counter() - t0,
                                records=len(cold.records), measurements=tuner.measurements)
    compiled = adapt_graph_check(granite, granite_params, failures)  # phase 14 (d)
    olmoe = LM(dataclasses.replace(get_config("olmoe-1b-7b"), n_layers=TUNE_OLMOE_LAYERS))
    olmoe_params = olmoe.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
    t0 = time.perf_counter()
    eng = engine_for(olmoe, olmoe_params, adaptive=adaptive)
    done_o = eng.run()
    served["olmoe-1b-7b"] = dict(requests=len(done_o), seconds=time.perf_counter() - t0,
                                 records=len(cold.records), measurements=tuner.measurements)
    del olmoe_params
    if len(done) != 4 or len(done_o) != 4:
        failures.append(f"tune: served {len(done)}/4 granite and {len(done_o)}/4 olmoe requests")
    fused = [k for k in cold.records if len(k) == 8]
    if not fused:
        failures.append("tune: no fused grouped fingerprint was tuned")
    n_bf16 = sum(profile_key(key_dtypes(k)) == bf16 for k in cold.records)
    extra = []
    if n_bf16 < MIN_RECORDS:
        # the baseline comparison's shapes (phase 2) as GemmOp targets, so the bf16 fit
        # has the records it needs; MIN_RECORDS stays as it is
        extra = [GemmOp.plain(m, n, k, in_dtype="bfloat16") for m in (N_SLOTS, PROMPT_M)
                 for n, k in SLICE_NK]
        extra = [op for op in extra if op.key not in cold.records]
        tuner.tune(extra, journal=journal)
    log(f"tune: cold serve adapted {adaptive.stats.adaptations} fingerprints "
        f"({adaptive.stats.misses} misses, sieve generation {selector.sieve_generation}); "
        f"{len(extra)} baseline-comparison targets tuned besides; {tuner.measurements} "
        f"measurements")

    # 2. the journal replayed into a fresh database, its snapshot round trip, the
    #    calibration and the sieve
    db = TuningDatabase()
    db.replay_journal(journal)
    snap = str(Path(tmp.name) / "tune.json")
    db.save(snap)
    back = TuningDatabase.load(snap)
    as_dicts = lambda d: {k: dataclasses.asdict(r) for k, r in d.records.items()}  # noqa: E731
    if as_dicts(back) != as_dicts(db) or back.per_policy != db.per_policy or db.load_errors:
        failures.append("tune: the snapshot round trip changed the records")
    n_bf16 = sum(profile_key(key_dtypes(k)) == bf16 for k in db.records)
    cm = None
    try:
        cm = calibrate_db(db, base=h100)
    except CalibrationError as e:
        failures.append(f"tune: calibration refused: {e}")
    if cm is not None and (bf16 not in cm.fitted_profiles or n_bf16 < MIN_RECORDS):
        failures.append(f"tune: the bf16 profile fitted on {n_bf16} records "
                        f"(MIN_RECORDS {MIN_RECORDS}), fitted {cm.fitted_profiles}")
    if cm is not None:
        db.set_calibration(cm)
    sieve = db.build_sieve()
    try:
        tn = sieve.validate_true_negative_rate(db.winners())
    except AssertionError as e:  # a winner the sieve prunes
        tn = str(e)
    for key in db.records:
        sieve.candidates(key)
    elim = sieve.stats.elimination_rate
    if tn != 1.0:
        failures.append(f"tune: the sieve's true-negative rate is {tn}")
    terms = lambda m: dict(peak_tflops=m.peak_flops / 1e12, hbm_gbps=m.hbm_bw / 1e9,  # noqa: E731
                           launch_us=m.launch_overhead_s * 1e6,
                           fixup_us=m.fixup_serial_s * 1e6)
    fitted = {pk: terms(m) for pk, m in cm.profiles} if cm is not None else {}
    ranker = Tuner(policies=selector.policies, tile_configs=selector.tile_configs, mach=h100,
                   grid_sizes=selector.grid_sizes)

    def ranks(calibration):
        ranker.calibration = calibration
        return dict(sorted(Counter(
            ranker._model_rank(_key_shape(k, k), key_dtypes(k), r.policy, r.cfg, r.g)
            for k, r in db.records.items()).items()))

    rank_nominal, rank_fitted = ranks(None), ranks(cm) if cm is not None else None
    by_policy = dict(sorted(Counter(r.policy for r in db.records.values()).items()))
    by_g = dict(sorted(Counter(r.g for r in db.records.values()).items()))
    dp_share = by_policy.get("dp", 0) / max(len(db.records), 1)
    log(f"tune: {len(db.records)} records replayed from the journal; winners by policy "
        f"{by_policy}, by g {by_g} (DP share {dp_share:.3f}); sieve true-negative rate {tn}, "
        f"elimination rate over the tuned keys {elim:.4f}")
    log(f"tune: nominal H100 {terms(h100)}; calibrated "
        f"{ {pk: {k: round(v, 3) for k, v in t.items()} for pk, t in fitted.items()} }, median "
        f"|rel resid| {cm.residual if cm is not None else None}; winner model_rank nominal "
        f"{rank_nominal}, calibrated {rank_fitted}")

    # 3. granite-8b served again from the warm state: launch counters zeroed just before and
    #    read just after; every dispatch a database hit; logits against the torch backend
    warm = KernelSelector(mach=h100, tile_configs=HOPPER_TILE_CONFIGS,
                          state=SelectorState(db=db, sieve=sieve, calibration=cm))
    eng = engine_for(granite, granite_params, selector=warm)
    reset_launch_counts()
    done = eng.run()
    torch.cuda.synchronize()
    launches = {name: n for name, n in LAUNCHES.items() if n}
    needed = set()
    for e in eng.selection_log:
        needed |= _kernels_of(e)
    sources = dict(Counter(e.selection.source for e in eng.selection_log))
    st = warm.stats
    if len(done) != 4 or sources != {"tuned": len(eng.selection_log)} or (
            st.sieve_hits or st.fallbacks or st.model_warm or st.xarch_seeds):
        failures.append(f"tune: warm serve {len(done)}/4, sources {sources} (sieve "
                        f"{st.sieve_hits}, fallback {st.fallbacks}, model {st.model_warm})")
    missing = sorted(name for name in needed if not launches.get(name))
    if missing or not needed:
        failures.append(f"tune: the warm serve never launched {missing}")
    got = eng.prefill_logits(prompts[0])
    with gemm_context(backend="torch"):
        want, _ = granite.prefill(granite_params, torch.as_tensor(prompts[0], device="cuda")[None])
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    tol = LOGITS_TOL["granite-8b"]
    if not torch.isfinite(got).all() or diff > tol * scale:
        failures.append(f"tune: warm prefill logits max|diff| {diff:.4f} > {tol} * {scale:.4f}")

    # 4. a warm decode step's GEMM device ms: the tuned picks beside the nominal model's
    cur = torch.zeros(N_SLOTS, dtype=torch.long, device="cuda")
    toks = torch.ones(N_SLOTS, 1, dtype=torch.long, device="cuda")
    scratch = granite.init_cache(N_SLOTS, MAX_SEQ, device="cuda")

    def step():
        granite.decode_step(granite_params, scratch, toks, cur)

    steps = {}
    for name, sel in (("nominal", default_selector("cuda")), ("tuned", warm)):
        with gemm_context(selector=sel, backend="cuda"):
            steps[name] = decode_breakdown(step)
    del scratch
    tmp.cleanup()
    del granite_params
    for name, bd in steps.items():
        log(f"tune: warm decode step, {name} picks: GEMM kernels {bd['gemm_kernels_ms']} ms, "
            f"device busy {bd['device_busy_ms']} ms, {bd['step_ms']:.2f} ms wall")
    seconds = time.perf_counter() - t_phase
    log(f"tune: warm serve launches {launches}; logits vs torch backend max|diff| {diff:.4f} "
        f"(limit {tol * scale:.4f}); phase {seconds:.1f}s")
    return dict(
        seconds=seconds, measurements=tuner.measurements, records=len(db.records),
        # phase 10 (d) queries filters of this geometry holding these winners; both are
        # taken out before the record
        sieve=sieve, winners=db.winners(),
        served=served, extra_targets=len(extra), adaptations=adaptive.stats.adaptations,
        misses=adaptive.stats.misses, sieve_generation=selector.sieve_generation,
        fused_records=len(fused), bf16_records=n_bf16, winners_by_policy=by_policy,
        winners_by_g=by_g, dp_share=dp_share, true_negative_rate=tn, elimination_rate=elim,
        nominal=terms(h100), calibrated=fitted,
        calibration_records=cm.n_records if cm is not None else 0,
        calibration_residual=cm.residual if cm is not None else None,
        model_rank_nominal=rank_nominal, model_rank_calibrated=rank_fitted,
        warm_sources=sources, warm_launches=launches, warm_logits_max_abs_diff=diff,
        warm_logits_max_abs=scale, logits_tol=tol,
        decode_gemm_ms={name: bd["gemm_kernels_ms"] for name, bd in steps.items()},
        decode_breakdown=steps, compiled=compiled,
    )


# ---------------------------------------------------------------------------
# Phase 5: paged serving and the fleet
# ---------------------------------------------------------------------------


#: the paged pool of phase 5: 16-row pages, the dense engine's rows (N_SLOTS x MAX_SEQ / 16
#: = 64 pages, the equal-memory pool), N_SLOTS active, and the chunk of chunked prefill
PAGE_SIZE, PREFILL_CHUNK = 16, 16
#: olmoe-1b-7b's depth in phase 5 (b): full width, two layers reach every fingerprint kind
PAGED_OLMOE_LAYERS = 2


def _paged_engine(model, params, chunk):
    """A ``PagedServeEngine`` of phase 5 on the card and the ``cuda``
    backend; raises if its pool or its GEMMs would run anywhere else."""
    from repro_torch.serve import PagedServeConfig, PagedServeEngine

    eng = PagedServeEngine(model, params, PagedServeConfig(
        page_size=PAGE_SIZE, max_pages=N_SLOTS * MAX_SEQ // PAGE_SIZE, max_active=N_SLOTS,
        max_seq=MAX_SEQ, prefill_chunk=chunk, eos=-1), backend="cuda")
    where = {key: a.device.type for key, a in eng.kv.pool["attn"].items()}
    if eng.backend != "cuda" or eng.device.type != "cuda" or set(where.values()) != {"cuda"}:
        raise AssertionError(f"paged engine off the card: backend {eng.backend}, device "
                             f"{eng.device}, pool {where}")
    return eng


def paged_run(label, model, params, chunk, failures, dense_tokens=None):
    """Serve the four prompts through a paged engine (``chunk`` 0: whole-
    prompt prefill), launch counters zeroed just before and read just after:
    every kernel the selections call for must have launched, and each fused
    grouped dispatch that ran eagerly must be exactly one B5 launch, each
    captured step's B5 launches one a replay. Phase 14 (b): one capture per
    padded table width, and the tokens and logits of the same run decoded
    eagerly. Returns the run's record (timing, pool and admission counters,
    tokens against ``dense_tokens`` by request)."""
    import torch

    from repro_torch.kernels.common import LAUNCHES, reset_launch_counts

    cfg = model.cfg
    eng = _paged_engine(model, params, chunk)
    _tap_logits(eng)
    prompts = serve_prompts(cfg.vocab_size)
    for p in prompts:
        eng.submit(p, max_new_tokens=8)
    reset_launch_counts()
    done = sorted(eng.run(), key=lambda r: r.uid)
    torch.cuda.synchronize()
    launches = {name: n for name, n in LAUNCHES.items() if n}
    if len(done) != 4 or eng.exhausted or any(len(r.out_tokens) != 8 for r in done):
        raise AssertionError(f"{label}: served {len(done)}/4 requests")
    needed = set()
    for e in eng.selection_log:
        needed |= _kernels_of(e)
    missing = [name for name in needed if launches.get(name, 0) <= 0]
    if missing or not needed:
        raise AssertionError(f"{label}: {missing} selected but never launched")
    grouped = b5_called_for(eng, label)
    b5 = sum(n for name, n in launches.items() if name.startswith("grouped_streamk"))
    if b5 != grouped:
        raise AssertionError(f"{label}: {b5} B5 launches for {grouped} grouped dispatches "
                             f"(the eager ones once, each captured step's once a replay)")
    tokens = {r.uid: r.out_tokens for r in done}
    widths = [c.key[0] for c in eng.decode.captured]
    most = math.ceil(math.log2(MAX_SEQ / PAGE_SIZE)) + 1
    if len(set(widths)) != len(widths) or len(widths) > most or any(w & (w - 1) for w in widths):
        failures.append(f"{label}: captures at padded table widths {widths} (at most {most} "
                        f"powers of two, one capture each)")
    compiled = graph_vs_eager(label, eng, tokens, lambda: _paged_engine(model, params, chunk),
                              prompts, LOGITS_TOL[cfg.name], failures)
    agree = None
    if dense_tokens is not None:
        agree = sum(a == b for uid, toks in tokens.items()
                    for a, b in zip(toks, dense_tokens[uid]))
    tm, m = eng.timing, eng.metrics()
    step_ms = tm["decode_s"] / max(tm["decode_steps"], 1) * 1e3
    log(f"{label}: launches {launches}; {grouped} grouped dispatches; decode step "
        f"{step_ms:.2f} ms wall over {tm['decode_steps']} steps, prefill {tm['prefill_s']:.3f}s "
        f"for {tm['prefill_tokens']} tokens; pool peak {m['peak_used_pages']}/{m['n_pages']} "
        f"pages, peak {m['peak_resident']} resident; admitted {m['admitted']}, rejected "
        f"{m['rejected']}, truncated {m['truncated']}, stall events {m['stall_events']}; "
        f"greedy tokens equal to the dense run's: {agree}/32")
    return dict(chunk=chunk, launches=launches, needed=sorted(needed), grouped=grouped,
                timing=dict(tm), decode_step_ms=step_ms, metrics=m, tokens=tokens,
                tokens_equal_dense=agree, compiled=compiled)


def paged_decode_check(model, params, failures):
    """One paged decode step (gather the view, the unchanged decode step on
    it, scatter the new rows) against the dense engine's step on the same
    prefilled requests and tokens, both on the ``cuda`` backend, held at
    granite's ``LOGITS_TOL``; then the planted fault, request 0's first
    page-table entry pointing at request 1's first page, which must read at
    least 3 times the limit. The dense step with its cache cut to the
    view's rows is read against both (reported): whether the two steps
    differ only by the attention's length. Also times the step's gather on
    its own."""
    import torch

    from repro_torch.core.gemm import gemm_context
    from repro_torch.serve import PageTable, ServeConfig, ServeEngine

    prompts = serve_prompts(model.cfg.vocab_size)
    dense = ServeEngine(model, params, ServeConfig(n_slots=N_SLOTS, max_seq=MAX_SEQ, eos=-1),
                        backend="cuda")
    paged = _paged_engine(model, params, 0)
    for eng in (dense, paged):
        for p in prompts:
            eng.submit(p, max_new_tokens=8)
    dense._admit()
    paged._admit()
    while paged._prefill_tick():
        pass
    reqs = paged._decode_candidates()
    if len(reqs) != 4:
        raise AssertionError(f"paged decode check: {len(reqs)} requests prefilled of 4")
    tokens = np.array([[r.out_tokens[-1]] for r in dense.slot_req], np.int64)
    pos = np.array([r.pos for r in reqs], np.int64)
    if not (pos == dense.pos).all():
        raise AssertionError(f"paged decode check: positions {pos} vs dense {dense.pos}")
    tables = [r.table for r in reqs]
    pages_2d = paged.kv.padded_tables(tables)
    view_rows = pages_2d.shape[1] * PAGE_SIZE
    # the dense cache cut to the view's rows: the same step with the
    # attention summed over as many rows as the paged view's
    cut_cache = {"attn": {key: leaf[:, :, :view_rows].clone()
                          for key, leaf in dense.cache["attn"].items()}}
    with gemm_context(selector=dense.selector, backend="cuda"):
        want, _ = model.decode_step(params, dense.cache, torch.as_tensor(tokens, device="cuda"),
                                    torch.as_tensor(dense.pos, device="cuda"))
        cut, _ = model.decode_step(params, cut_cache, torch.as_tensor(tokens, device="cuda"),
                                   torch.as_tensor(dense.pos, device="cuda"))
    del cut_cache
    with paged._dispatch_ctx():
        got = paged._paged_decode(pages_2d, tokens, pos, 4)
        bad_tables = [PageTable([reqs[1].table.pages[0]] + reqs[0].table.pages[1:])] + tables[1:]
        bad = paged._paged_decode(paged.kv.padded_tables(bad_tables), tokens, pos, 4)
    got, want, bad, cut = got.float(), want.float(), bad.float(), cut.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"paged decode check: bad logits {tuple(got.shape)}")
    tol = LOGITS_TOL["granite-8b"]
    diff = (got - want).abs().max().item()
    scale = want.abs().max().item()
    fault = (bad - want).abs().max().item() if torch.isfinite(bad).all() else math.inf
    cut_vs_paged = (cut - got).abs().max().item()
    cut_vs_dense = (cut - want).abs().max().item()
    log(f"paged decode step vs the dense engine's step (granite-8b, cuda backend): max|diff| "
        f"{diff:.4f} (max|logit| {scale:.4f}, limit {tol * scale:.4f}); planted fault (request "
        f"0's first page -> request 1's) {fault:.4f} (must be >= {3 * tol * scale:.4f})")
    log(f"the dense step with its cache cut to the view's {view_rows} rows (of {MAX_SEQ}): vs "
        f"the paged step {cut_vs_paged:.4f} ({cut_vs_paged / scale:.3e} x max|logit|), vs the "
        f"uncut dense step {cut_vs_dense:.4f} ({cut_vs_dense / scale:.3e}); reported")
    if diff > tol * scale:
        failures.append(f"paged decode logits: max|diff| {diff:.4f} > {tol} * {scale:.4f}")
    if fault < 3 * tol * scale:
        failures.append(f"paged decode planted fault must read at least 3x the limit: "
                        f"{fault:.4f} < 3 * {tol} * {scale:.4f}")
    # the gather of the run's largest view: 5 pages a request (prompt and 8
    # new tokens), padded to 8
    pages_2d = paged.kv.padded_tables(
        [PageTable(r.table.pages + paged.kv.alloc(5 - len(r.table.pages))) for r in reqs])
    view = paged.kv.gather_view(paged.kv.pool, pages_2d)
    gather_bytes = 2 * sum(a.numel() * a.element_size() for a in view["attn"].values())
    gather_ms, gather_event_ms = time_ms(lambda: paged.kv.gather_view(paged.kv.pool, pages_2d))
    log(f"gather of a decode step's view {tuple(view['attn']['k'].shape)}: {gather_ms:.4f} ms "
        f"device ({gather_event_ms:.4f} event), {gather_bytes / 1e6:.1f} MB read and written, "
        f"{gather_bytes / gather_ms / 1e6:.0f} GB/s")
    return dict(logits_max_abs_diff=diff, logits_max_abs=scale, logits_tol=tol,
                planted_fault_max_abs_diff=fault, view_rows=view_rows,
                cut_cache_vs_paged_max_abs_diff=cut_vs_paged,
                cut_cache_vs_dense_max_abs_diff=cut_vs_dense,
                gather_view_shape=list(view["attn"]["k"].shape),
                gather_ms=gather_ms, gather_event_ms=gather_event_ms, gather_bytes=gather_bytes)


def chunked_prefill_check(model, params, failures, *, tol, routing=False):
    """Prefill the first prompt through a paged engine in ``PREFILL_CHUNK``
    chunks; its last chunk's logits against the whole-prompt prefill on the
    ``cuda`` backend (``routing``: against the ``torch`` backend replaying
    the chunked run's top-k choices, with the router logits held against
    ``torch.matmul`` at ``ROUTER_TOL``), within ``tol`` x max|logit|; then
    the planted fault, the last chunk attending over a zeroed prefix (a
    view without its cache prefix), which must read at least 3 times the
    limit."""
    import torch

    from repro_torch.core.gemm import gemm_context

    label = f"{model.cfg.name} chunked prefill"
    prompt = serve_prompts(model.cfg.vocab_size)[0]
    tokens = torch.as_tensor(prompt, device="cuda")[None]
    eng = _paged_engine(model, params, PREFILL_CHUNK)
    eng.submit(prompt, max_new_tokens=8)
    eng._admit()
    req = eng.active[0]
    chunks = []
    paged_chunk = eng._paged_chunk

    def recording(*a):
        chunks.append(paged_chunk(*a))
        return chunks[-1]

    eng._paged_chunk = recording
    with routing_log(check_router=routing) as routes:
        while len(prompt) - req.prefilled > PREFILL_CHUNK:
            eng._prefill_tick()
        start = req.prefilled
        eng._prefill_tick()  # the last chunk
    got = chunks[-1].float()
    view = eng.kv.gather_view(eng.kv.pool, eng.kv.padded_tables([req.table]))
    for leaf in view["attn"].values():
        leaf[:, :, :start] = 0
    with routing_log() as bad_routes, eng._dispatch_ctx():
        bad, _ = model.prefill_chunk(params, view, tokens[:, start:],
                                     torch.tensor([start], device="cuda"))
    if routing:
        def chained(replay):
            with routing_replay(replay), gemm_context(backend="torch"):
                out, cache = model.prefill(params, tokens[:, :PREFILL_CHUNK], max_seq=MAX_SEQ)
                for s in range(PREFILL_CHUNK, len(prompt), PREFILL_CHUNK):
                    out, cache = model.prefill_chunk(params, cache, tokens[:, s:s + PREFILL_CHUNK],
                                                     torch.tensor([s], device="cuda"))
            return out.float()

        want = chained(routes)
        bad_want = chained(routes[:-len(bad_routes)] + list(bad_routes))
    else:
        with gemm_context(selector=eng.selector, backend="cuda"):
            want, _ = model.prefill(params, tokens)
        want = bad_want = want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: bad logits {tuple(got.shape)}")
    diff = (got - want).abs().max().item()
    scale = want.abs().max().item()
    fault = (bad.float() - bad_want).abs().max().item() if torch.isfinite(bad).all() else math.inf
    against = ("the torch backend replaying its top-k choices, chunk by chunk" if routing
               else "the whole-prompt prefill")
    log(f"{label} ({len(prompt)} tokens, {len(chunks) + 1} chunks of {PREFILL_CHUNK}) vs "
        f"{against}: max|diff| {diff:.4f} (max|logit| {scale:.4f}, limit {tol * scale:.4f}); "
        f"planted fault (the last chunk without its prefix) {fault:.4f} (must be >= "
        f"{3 * tol * scale:.4f})" + (f"; router logits vs torch.matmul {routes.router_err:.3e} "
                                     f"(limit {ROUTER_TOL})" if routing else ""))
    if diff > tol * scale:
        failures.append(f"{label}: max|diff| {diff:.4f} > {tol} * {scale:.4f}")
    if fault < 3 * tol * scale:
        failures.append(f"{label}: the planted fault must read at least 3x the limit: "
                        f"{fault:.4f} < 3 * {tol} * {scale:.4f}")
    if routing and routes.router_err > ROUTER_TOL:
        failures.append(f"{label}: router logits vs torch.matmul {routes.router_err:.3e} > "
                        f"{ROUTER_TOL}")
    return dict(prompt_len=len(prompt), chunks=len(chunks) + 1, logits_max_abs_diff=diff,
                logits_max_abs=scale, logits_tol=tol, planted_fault_max_abs_diff=fault,
                router_max_rel_err=routes.router_err if routing else None)


def phase_paged_granite(model, params, runs, failures):
    """Phase 5 (a): granite-8b at full width on phase 3's bf16 weights,
    paged, whole-prompt and chunked (see the module docstring)."""
    t0 = time.perf_counter()
    dense = runs["dense"]
    dense_tokens = {int(uid): toks for uid, toks in dense["tokens"].items()}
    out = dict(whole=paged_run("granite-8b paged", model, params, 0, failures, dense_tokens),
               chunked=paged_run(f"granite-8b paged, chunks of {PREFILL_CHUNK}", model, params,
                                 PREFILL_CHUNK, failures, dense_tokens))
    for name in ("dp_gemm_region", "streamk_phase1"):  # B1 and B2 on the cuda backend
        for run in ("whole", "chunked"):
            if out[run]["launches"].get(name, 0) <= 0:
                raise AssertionError(f"granite-8b paged ({run}): {name} never launched")
    out["decode"] = paged_decode_check(model, params, failures)
    out["chunk"] = chunked_prefill_check(model, params, failures, tol=LOGITS_TOL["granite-8b"])
    out["dense_decode_step_ms"] = dense["decode_step_ms"]
    out["seconds"] = time.perf_counter() - t0
    log(f"granite-8b wall ms per decode step: paged {out['whole']['decode_step_ms']:.2f} "
        f"(chunked {out['chunked']['decode_step_ms']:.2f}) beside dense "
        f"{dense['decode_step_ms']:.2f} (phase 3); phase 5 (a) {out['seconds']:.1f}s")
    return out


def phase_paged_olmoe(failures):
    """Phase 5 (b): olmoe-1b-7b at full width and ``PAGED_OLMOE_LAYERS``
    layers, paged with chunked prefill: one B5 launch per fused grouped
    dispatch, and the chunked logits held as phase 3 holds olmoe's."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM

    t0 = time.perf_counter()
    model = LM(dataclasses.replace(get_config("olmoe-1b-7b"), n_layers=PAGED_OLMOE_LAYERS))
    params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
    out = dict(run=paged_run(f"olmoe-1b-7b x {PAGED_OLMOE_LAYERS} layers paged, chunks of "
                             f"{PREFILL_CHUNK}", model, params, PREFILL_CHUNK, failures))
    if out["run"]["grouped"] <= 0:
        raise AssertionError("olmoe-1b-7b paged: no fused grouped dispatch")
    out["chunk"] = chunked_prefill_check(model, params, failures,
                                         tol=LOGITS_TOL["olmoe-1b-7b"], routing=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_fleet_cli(failures):
    """Phase 5 (c): the serve CLI at full width, in this process through
    ``main(argv)``: granite-8b, paged with chunked prefill, poisson replay,
    two gossiping workers adapting online into a temporary journal; then the
    same command with ``--merge-journals`` and without ``--adapt``, where
    every decode dispatch must be a database hit."""
    import os
    import tempfile

    import torch

    from repro_torch.kernels.common import LAUNCHES, reset_launch_counts
    from repro_torch.launch import serve as cli

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        base = ["--arch", "granite-8b", "--preset", "full", "--paged", "--prefill-chunk",
                str(PREFILL_CHUNK), "--replay", "poisson", "--requests", "8", "--slots",
                str(N_SLOTS), "--max-seq", str(MAX_SEQ), "--max-new-tokens", "8", "--workers",
                "2", "--journal", os.path.join(tmp, "fleet.jsonl"), "--top-k", "5",
                "--gossip-every", "2"]
        for name, extra in (("adapt", ["--adapt", "--adapt-every", "1"]),
                            ("merged", ["--merge-journals"])):
            summary = os.path.join(tmp, f"{name}.json")
            reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main(base + extra + ["--summary-json", summary])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {n: c for n, c in LAUNCHES.items() if c}
            with open(summary) as f:
                run = json.load(f)
            run.update(rc=rc, seconds=seconds, launches=launches)
            out[name] = run
            gc.collect()
            torch.cuda.empty_cache()
            label = f"serve CLI ({name})"
            if rc != 0 or run["completed"] != 8:
                raise AssertionError(f"{label}: rc {rc}, {run['completed']}/8 requests")
            if not run["device"].startswith("cuda") or {w["backend"] for w in run["workers"]} != {
                    "cuda"}:
                raise AssertionError(f"{label}: served on {run['device']}, backends "
                                     f"{[w['backend'] for w in run['workers']]}")
            for kernel in ("dp_gemm_region", "streamk_phase1"):
                if launches.get(kernel, 0) <= 0:
                    raise AssertionError(f"{label}: {kernel} never launched")
            for w in run["workers"]:
                m, slo, gs = w["pool"], w.get("slo_steps", {}), w.get("gossip", {})
                step_ms = w["timing"]["decode_s"] / max(w["timing"]["decode_steps"], 1) * 1e3
                log(f"{label} worker {w['worker']}: {w['completed']}/{w['requests']} requests, "
                    f"decode {step_ms:.2f} ms/step wall; pool peak {m['peak_used_pages']}/{m['n_pages']} pages, peak "
                    f"{m['peak_resident']} resident; admitted {m['admitted']}, rejected "
                    f"{m['rejected']}, truncated {m['truncated']}, stalls {m['stall_events']}; SLO "
                    f"steps latency p50 {slo.get('latency_p50')} p99 {slo.get('latency_p99')}, "
                    f"ttft p50 {slo.get('ttft_p50')} p99 {slo.get('ttft_p99')}; gossip "
                    f"{gs.get('rounds')} rounds, {gs.get('entries')} entries, "
                    f"{gs.get('swaps')} swaps; sources {w['sources']}, decode "
                    f"{w['decode_sources']}")
            fed = run.get("federation", {})
            log(f"{label}: rc {rc} in {seconds:.1f}s; launches {launches}; fleet journals "
                f"federate to {fed.get('records')} records, {fed.get('conflicts')} conflicts")
        w1 = out["adapt"]["workers"][1]["gossip"]
        if w1["rounds"] <= 0 or w1["entries"] <= 0:
            failures.append(f"serve CLI: worker 1's gossip absorbed nothing: {w1}")
        for w in out["merged"]["workers"]:
            if set(w["decode_sources"]) != {"tuned"}:
                failures.append(f"serve CLI --merge-journals: worker {w['worker']}'s decode "
                                f"dispatches were {w['decode_sources']}, not all tuned")
    return out


def phase_paged(granite, failures):
    """Phase 5 (b) and (c), with (a) run beforehand inside phase 3
    (``granite``, on its weights); returns the phase's record."""
    t0 = time.perf_counter()
    out = dict(granite=granite, olmoe=phase_paged_olmoe(failures))
    gc.collect()
    import torch

    torch.cuda.empty_cache()
    out["cli"] = phase_fleet_cli(failures)
    out["seconds"] = time.perf_counter() - t0 + granite["seconds"]
    log(f"phase 5 (paged serving and the fleet): {out['seconds']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# Phase 6: four more configs at full width
# ---------------------------------------------------------------------------

#: phase 6's cells: (arch, layers). The two that fit the card serve every layer; mistral
#: (245 GB of bf16 weights) and qwen3-moe (463 GB) keep their full widths and two layers
#: (arch, layers; None: full depth): gemma3-27b cut from 62 to 30 layers (five of its
#: local:global groups) in PR 32 to make room for phase 12 in the time limit
ARCH_CELLS = (("nemotron-4-15b", None), ("gemma3-27b", 30), ("mistral-large-123b", 2),
              ("qwen3-moe-235b-a22b", 2))
#: gemma3's long request: a prompt past its 1024-row window, and the cache length it serves
#: in; the ring path decodes ``LONG_NEW`` tokens
LONG_PROMPT, LONG_MAX_SEQ, LONG_NEW = 1100, 1152, 8


def phase_archs(failures):
    """Phase 6: serve nemotron-4-15b, gemma3-27b, mistral-large-123b and
    qwen3-moe-235b-a22b at full width, the last three cut to ``ARCH_CELLS``'
    layers, one model on the card at a time (see the module docstring).
    Returns each model's record by arch."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM

    t_phase = time.perf_counter()
    out = {}
    for arch, layers in ARCH_CELLS:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        torch.cuda.reset_peak_memory_stats()
        model = LM(cfg)
        params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
        n_params = sum(t.numel() for t in _leaves(params))
        head_bytes = 0
        if cfg.tie_embeddings:  # the tied head's one contiguous copy, made here at load
            head = model.head_weight(params)
            head_bytes = head.numel() * head.element_size()
            del head
        torch.cuda.synchronize()
        label = arch if not layers else f"{arch} x {layers} layers"
        log(f"{label}: {n_params / 1e9:.3f} B parameters (cfg.param_count() "
            f"{cfg.param_count() / 1e9:.3f} B), {torch.cuda.memory_allocated() / 1e9:.2f} GB on "
            f"the card (tied head copy {head_bytes / 1e9:.2f} GB) in "
            f"{time.perf_counter() - t0:.1f}s")
        if n_params != cfg.param_count():
            failures.append(f"{label}: {n_params} parameters instantiated, cfg.param_count() "
                            f"{cfg.param_count()}")
        run = serve_run(arch, model, params, None, failures, b1_fault=cfg.family == "dense")
        run.pop("logits")
        run.update(layers=cfg.n_layers, n_params=n_params, param_count=cfg.param_count(),
                   head_copy_bytes=head_bytes)
        grouped_g = run["grouped_g"]
        if cfg.family == "moe":
            b5 = sum(n for name, n in run["launches"].items() if name.startswith("grouped"))
            log(f"{label}: {b5} B5 launches at G = {grouped_g}")
            if grouped_g != [cfg.n_experts] or b5 <= 0:
                failures.append(f"{label}: B5 ran at G = {grouped_g} ({b5} launches), not "
                                f"G = {cfg.n_experts}")
        if cfg.mlp_act == "squared_relu" and not run["square_dispatches"]:
            failures.append(f"{label}: no mlp.in dispatch carried the square epilogue")
        run["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9  # load and serve
        if cfg.tie_embeddings:
            run["head"] = tied_head_check(model, params, head_bytes, failures)
        if cfg.window:
            torch.cuda.reset_peak_memory_stats()
            run["long"] = long_request_check(model, params, failures)
            run["long"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        run["seconds"] = time.perf_counter() - t0
        log(f"{label}: peak {run['peak_gb']:.2f} GB allocated on the card while loaded and "
            f"served" + (f", {run['long']['peak_gb']:.2f} GB in the long request" if cfg.window
                         else "") + f"; {run['seconds']:.1f}s")
        out[arch] = run
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 6 (four more configs): {time.perf_counter() - t_phase:.1f}s")
    return out


def tied_head_check(model, params, head_bytes, failures):
    """gemma3's tied head: the device ms of its GEMM at the decode shape (M
    = ``N_SLOTS``, the selector's pick), and the memory a warm decode step
    allocates beyond what it holds, which must stay below the head's copy:
    a dispatch that copied ``embed.T`` would allocate all of it."""
    import torch

    from repro_torch.core.gemm import gemm, gemm_context
    from repro_torch.core.selector import default_selector

    cfg = model.cfg
    head = model.head_weight(params)
    x = torch.randn(N_SLOTS, 1, cfg.d_model, device="cuda").to(torch.bfloat16)
    with gemm_context(selector=default_selector("cuda"), backend="cuda") as ctx:
        head_ms, head_event_ms = time_ms(lambda: gemm(x, head, tag="lm_head",
                                                      out_dtype=cfg.dtype))
    sel = ctx.log[0].selection
    cache = model.init_cache(N_SLOTS, MAX_SEQ, device="cuda")
    toks = torch.ones(N_SLOTS, 1, dtype=torch.long, device="cuda")
    cur = torch.zeros(N_SLOTS, dtype=torch.long, device="cuda")
    with gemm_context(backend="cuda"):
        model.decode_step(params, cache, toks, cur)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model.decode_step(params, cache, toks, cur)
        torch.cuda.synchronize()
    transient = torch.cuda.max_memory_allocated() - before
    same = model.head_weight(params) is head
    log(f"{cfg.name} tied head ({cfg.d_model} x {cfg.vocab_size}, {head_bytes / 1e9:.2f} GB, "
        f"built once): {sel.policy.name}/{sel.cfg.name}/g{sel.g} at M = {N_SLOTS}: device "
        f"{head_ms:.4f} ms, events {head_event_ms:.4f} ms; a warm decode step allocates "
        f"{transient / 1e9:.3f} GB beyond what it holds; the same copy on every dispatch: {same}")
    if not same or transient >= head_bytes // 2:
        failures.append(f"{cfg.name}: the tied head was copied at dispatch (same copy: {same}; "
                        f"a decode step allocated {transient / 1e9:.3f} GB)")
    return dict(device_ms=head_ms, event_ms=head_event_ms, bytes=head_bytes,
                pick=f"{sel.policy.name}/{sel.cfg.name}/g{sel.g}",
                decode_step_transient_bytes=transient, reused=same)


@contextmanager
def windows_off(model):
    """The planted fault of the long request: every layer of ``model`` made
    global (no window), its parameters and tied head left as they are."""
    import dataclasses

    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, window=0, global_every=0)
    try:
        yield model
    finally:
        model.cfg = cfg


def long_request_check(model, params, failures):
    """gemma3's long request, a seeded prompt of ``LONG_PROMPT`` tokens past
    the 1024-row window, cache length ``LONG_MAX_SEQ``: (a) its prefill
    logits on the ``cuda`` backend against the ``torch`` backend within
    ``LOGITS_TOL``; (b) ``LONG_NEW`` greedy decode steps on the uniform
    cache, and the same steps on the ring path
    (``windowed_cache_from_uniform`` of the prefill cache, then
    ``decode_step_windowed`` fed the uniform path's tokens), each step's
    logits within ``LOGITS_TOL`` of the uniform step's, with the tokens'
    agreement reported; (c) the planted fault, every layer global, whose
    prefill logits must read at least 3 times (a)'s limit against the
    ``torch`` backend's."""
    import torch

    from repro_torch.core.gemm import gemm_context

    t0 = time.perf_counter()
    cfg = model.cfg
    tol = LOGITS_TOL[cfg.name]
    prompt = np.random.default_rng(1).integers(1, cfg.vocab_size, size=LONG_PROMPT)
    tokens = torch.as_tensor(prompt, device="cuda")[None]
    with gemm_context(backend="cuda"):
        got, ucache = model.prefill(params, tokens, max_seq=LONG_MAX_SEQ)
        ring = model.windowed_cache_from_uniform(ucache, LONG_PROMPT)
    with gemm_context(backend="torch"):
        want, _ = model.prefill(params, tokens, max_seq=LONG_MAX_SEQ)
    got, want = got.float(), want.float()
    if got.shape != (1, 1, cfg.vocab_size) or not torch.isfinite(got).all():
        raise AssertionError(f"{cfg.name} long request: bad prefill logits {tuple(got.shape)}")
    diff = (got - want).abs().max().item()
    scale = want.abs().max().item()
    with windows_off(model), gemm_context(backend="cuda"):
        bad, _ = model.prefill(params, tokens, max_seq=LONG_MAX_SEQ)
    fault = (bad.float() - want).abs().max().item() if torch.isfinite(bad).all() else math.inf
    del bad

    # (b) the uniform cache's greedy steps, then the ring path fed its tokens
    uniform, fed = [], []
    tok = got.argmax(-1)
    with gemm_context(backend="cuda"):
        for i in range(LONG_NEW):
            pos = torch.tensor([LONG_PROMPT + i], device="cuda")
            fed.append(tok)
            out, ucache = model.decode_step(params, ucache, tok, pos)
            uniform.append(out.float())
            tok = out.argmax(-1)
        ring_steps = []
        for i in range(LONG_NEW):
            pos = torch.tensor([LONG_PROMPT + i], device="cuda")
            out, ring = model.decode_step_windowed(params, ring, fed[i], pos)
            ring_steps.append(out.float())
    del ucache, ring
    ring_diffs = [(r - u).abs().max().item() / u.abs().max().item()
                  for r, u in zip(ring_steps, uniform)]
    agree = sum(int(r.argmax()) == int(u.argmax()) for r, u in zip(ring_steps, uniform))
    ring_ok = all(torch.isfinite(r).all() for r in ring_steps)
    log(f"{cfg.name} long request ({LONG_PROMPT} tokens, window {cfg.window}, max_seq "
        f"{LONG_MAX_SEQ}): prefill logits vs the torch backend max|diff| {diff:.4f} (max|logit| "
        f"{scale:.4f}, limit {tol * scale:.4f}); planted fault (every layer global) {fault:.4f} "
        f"({fault / scale:.3e} x max|logit|, must be >= {3 * tol * scale:.4f})")
    log(f"{cfg.name} ring path, {LONG_NEW} steps fed the uniform path's tokens: max|diff| x "
        f"max|logit| per step {[f'{d:.2e}' for d in ring_diffs]} (limit {tol}); greedy tokens "
        f"agree {agree}/{LONG_NEW} ({time.perf_counter() - t0:.1f}s)")
    if diff > tol * scale:
        failures.append(f"{cfg.name} long request: prefill logits max|diff| {diff:.4f} > {tol} "
                        f"* {scale:.4f}")
    if not ring_ok or max(ring_diffs) > tol:
        failures.append(f"{cfg.name} ring path: per-step max|diff| x max|logit| {ring_diffs} "
                        f"> {tol}")
    if fault < 3 * tol * scale:
        failures.append(f"{cfg.name} long request: the planted fault (every layer global) "
                        f"must read at least 3x the limit: {fault:.4f} < 3 * {tol} * "
                        f"{scale:.4f}")
    return dict(prompt_len=LONG_PROMPT, max_seq=LONG_MAX_SEQ, new_tokens=LONG_NEW,
                logits_max_abs_diff=diff, logits_max_abs=scale, logits_tol=tol,
                planted_fault_max_abs_diff=fault, ring_step_rel_diffs=ring_diffs,
                ring_tokens_agree=agree, seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# Phase 7: the SSM, hybrid, encoder-decoder and VLM families at full width
# ---------------------------------------------------------------------------

#: phase 7's cells at full width, one model on the card at a time: (arch, layers; None:
#: full depth). llava-next-34b last, when every other model has been freed, cut to 10 of
#: its 60 layers (cut in PR 32 to make room for phase 12 in the time limit)
FAMILY_CELLS = (("mamba2-1.3b", None), ("zamba2-1.2b", None), ("whisper-large-v3", None),
                ("llava-next-34b", 10))
#: mamba2's slot reuse: this many requests through ``N_SLOTS`` slots
REUSE_REQUESTS = 8
#: llava's image request: its cache length and decode steps
IMAGE_MAX_SEQ, IMAGE_STEPS = 704, 8
#: whisper: requests in one batch, decoder prompt tokens, decode steps
WHISPER_REQUESTS, WHISPER_PROMPT, WHISPER_STEPS = 4, 8, 8


def phase_families(failures):
    """Phase 7: serve mamba2-1.3b, zamba2-1.2b, whisper-large-v3 and
    llava-next-34b at full width, at the depth of ``FAMILY_CELLS``, one
    model on the card at a time (see the module docstring). Returns each
    model's record by arch."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    out = {}
    for arch, layers in FAMILY_CELLS:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg)
        params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
        n_params = sum(t.numel() for t in _leaves(params))
        head_bytes = 0
        if cfg.tie_embeddings:  # the tied head's one contiguous copy, made here at load
            head = model.head_weight(params)
            head_bytes = head.numel() * head.element_size()
            del head
        torch.cuda.synchronize()
        log(f"{arch}: {n_params / 1e9:.3f} B parameters (cfg.param_count() "
            f"{cfg.param_count() / 1e9:.3f} B), {torch.cuda.memory_allocated() / 1e9:.2f} GB on "
            f"the card (tied head copy {head_bytes / 1e9:.2f} GB) in "
            f"{time.perf_counter() - t0:.1f}s")
        if n_params != cfg.param_count():
            failures.append(f"{arch}: {n_params} parameters instantiated, cfg.param_count() "
                            f"{cfg.param_count()}")
        if cfg.family == "encdec":
            run = whisper_run(model, params, failures)
        else:
            run = serve_run(arch, model, params, None, failures, b1_fault=True)
            run.pop("logits")
        run.update(layers=cfg.n_layers, n_params=n_params, param_count=cfg.param_count(),
                   head_copy_bytes=head_bytes)
        launches = run["launches"]
        b5 = sum(n for name, n in launches.items() if name.startswith("grouped"))
        if not launches.get("dp_gemm_region") or not launches.get("streamk_phase1") or b5:
            failures.append(f"{arch}: B1 and B2 must launch and B5 must not: {launches}")
        run["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9  # load and serve
        if cfg.tie_embeddings:
            run["head"] = tied_head_check(model, params, head_bytes, failures)
        if arch == "mamba2-1.3b":
            run["slot_reuse"] = slot_reuse_check(model, params, failures)
        if cfg.family == "vlm":
            torch.cuda.reset_peak_memory_stats()
            run["image"] = image_request_check(model, params, failures)
            run["image"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        run["seconds"] = time.perf_counter() - t0
        log(f"{arch}: peak {run['peak_gb']:.2f} GB allocated on the card while loaded and "
            f"served; {run['seconds']:.1f}s")
        out[arch] = run
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 7 (the SSM, hybrid, encoder-decoder and VLM families): "
        f"{time.perf_counter() - t_phase:.1f}s")
    return out


def slot_reuse_check(model, params, failures):
    """mamba2's state across requests: ``REUSE_REQUESTS`` seeded prompts
    served through ``N_SLOTS`` slots (each slot serves two requests in turn)
    give each request the greedy tokens of the same prompt served alone in
    a fresh engine, so a slot's prefill replaces its SSM state and conv
    tail."""
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    t0 = time.perf_counter()
    cfg = model.cfg
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(rng.integers(16, 65)))
               for _ in range(REUSE_REQUESTS)]

    def serve(batch):
        engine = ServeEngine(model, params, ServeConfig(n_slots=N_SLOTS, max_seq=MAX_SEQ, eos=-1),
                             backend="cuda")
        for p in batch:
            engine.submit(p, max_new_tokens=8)
        return [r.out_tokens for r in sorted(engine.run(), key=lambda r: r.uid)]

    shared = serve(prompts)
    alone = [serve([p])[0] for p in prompts]
    same = sum(a == b for a, b in zip(shared, alone))
    log(f"{cfg.name} slot reuse: {REUSE_REQUESTS} requests through {N_SLOTS} slots give the "
        f"tokens of each served alone: {same}/{REUSE_REQUESTS} ({time.perf_counter() - t0:.1f}s)")
    if len(shared) != REUSE_REQUESTS or same != REUSE_REQUESTS:
        failures.append(f"{cfg.name}: reused slots gave other tokens than each request served "
                        f"alone ({same}/{REUSE_REQUESTS} equal): {shared} vs {alone}")
    return dict(requests=REUSE_REQUESTS, slots=N_SLOTS, equal=same, tokens=shared,
                seconds=time.perf_counter() - t0)


def _held_steps(label, got, want, tol, failures):
    """Each step's max|diff| of ``got`` against ``want`` over that step's
    max|logit|; a non-finite step or a reading above ``tol`` is a failure."""
    import torch

    readings = []
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.isfinite(g).all():
            failures.append(f"{label}: step {i} logits not finite")
            readings.append(math.inf)
            continue
        readings.append((g - w).abs().max().item() / w.abs().max().item())
    if max(readings) > tol:
        failures.append(f"{label}: max|diff| x max|logit| per step {readings} > {tol}")
    return readings


def _greedy_steps(model, params, cache, first, pos0, steps, fed=None):
    """``steps`` decode steps from the greedy token of the ``first`` logits
    at positions ``pos0 ...``, or fed ``fed``'s tokens; returns (each
    step's f32 logits, the tokens fed)."""
    import torch

    tok, out, tokens = first[:, -1].argmax(-1, keepdim=True), [], []
    for i in range(steps):
        tok = fed[i] if fed is not None else tok
        tokens.append(tok)
        pos = torch.full((tok.shape[0],), pos0 + i, device="cuda")
        logits, cache = model.decode_step(params, cache, tok, pos)
        out.append(logits.float())
        tok = logits[:, -1].argmax(-1, keepdim=True)
    return out, tokens


def image_request_check(model, params, failures):
    """llava's image request: ``n_patches`` seeded patch embeddings, drawn
    at the token embeddings' scale (std 1/sqrt(vocab), the init of the
    embedding table), before the first serve prompt's text (the token array
    is the text padded by the patch count, so text token i sits at position
    P + i); prefill with ``max_seq`` ``IMAGE_MAX_SEQ`` and ``IMAGE_STEPS``
    greedy decode steps on the ``cuda`` backend, the prefill's and every
    step's logits against the ``torch`` backend fed the same tokens within
    ``LOGITS_TOL``, and the planted fault, the patches dropped on the same
    tokens, which must read at least 3 times the limit."""
    import torch

    from repro_torch.core.gemm import gemm_context

    t0 = time.perf_counter()
    cfg = model.cfg
    tol = LOGITS_TOL[cfg.name]
    p = cfg.n_patches
    text = serve_prompts(cfg.vocab_size)[0]
    tokens = torch.as_tensor(np.concatenate([text, np.zeros(p, text.dtype)]), device="cuda")[None]
    std = 1.0 / math.sqrt(cfg.vocab_size)
    gen = torch.Generator(device="cuda").manual_seed(2)
    patches = (torch.randn(1, p, cfg.d_model, generator=gen, device="cuda") * std).to(
        torch.bfloat16)
    pos0 = p + len(text)
    runs = {}
    for backend in ("cuda", "torch"):
        with gemm_context(backend=backend):
            first, cache = model.prefill(params, tokens, max_seq=IMAGE_MAX_SEQ,
                                         patch_embeds=patches)
            steps, fed = _greedy_steps(model, params, cache, first, pos0, IMAGE_STEPS,
                                       fed=runs["cuda"][1] if backend == "torch" else None)
        runs[backend] = ([first.float()] + steps, fed)
        del cache
    got, want = runs["cuda"][0], runs["torch"][0]
    readings = _held_steps(f"{cfg.name} image request", got, want, tol, failures)
    with gemm_context(backend="cuda"):
        bad, _ = model.prefill(params, tokens, max_seq=IMAGE_MAX_SEQ)
    scale = want[0].abs().max().item()
    fault = (bad.float() - want[0]).abs().max().item() if torch.isfinite(bad).all() else math.inf
    if fault < 3 * tol * scale:
        failures.append(f"{cfg.name} image request: the planted fault (patches dropped) must "
                        f"read at least 3x the limit: {fault:.4f} < 3 * {tol} * {scale:.4f}")
    new = [int(t) for t in torch.cat(runs["cuda"][1] + [got[-1][:, -1].argmax(-1, keepdim=True)],
                                     dim=1)[0]]
    if not all(0 <= t < cfg.vocab_size for t in new):
        failures.append(f"{cfg.name} image request: bad tokens {new}")
    log(f"{cfg.name} image request ({p} patches at std {std:.5f}, {len(text)} text tokens, "
        f"max_seq {IMAGE_MAX_SEQ}): prefill and {IMAGE_STEPS} decode steps vs the torch backend "
        f"fed the same tokens, max|diff| x max|logit| {[f'{r:.2e}' for r in readings]} (limit "
        f"{tol}); planted fault (patches dropped) {fault:.4f} ({fault / scale:.3e} x max|logit|, "
        f"must be >= {3 * tol * scale:.4f}); tokens {new} ({time.perf_counter() - t0:.1f}s)")
    return dict(patches=p, patch_std=std, text_len=len(text), max_seq=IMAGE_MAX_SEQ,
                decode_steps=IMAGE_STEPS, step_readings=readings, logits_tol=tol,
                logits_max_abs=scale, planted_fault_max_abs_diff=fault, tokens=new,
                seconds=time.perf_counter() - t0)


def whisper_run(model, params, failures):
    """whisper-large-v3 through ``EncDec.prefill`` and
    ``EncDec.decode_step``: ``WHISPER_REQUESTS`` requests of
    ``enc_frames`` seeded frame embeddings (standard normal) and a seeded
    ``WHISPER_PROMPT``-token decoder prompt, prefilled as one batch, then
    ``WHISPER_STEPS`` greedy decode steps with ``max_seq`` ``MAX_SEQ``, on
    the ``cuda`` backend with launch counters zeroed just before; the
    prefill's and every step's logits against the ``torch`` backend fed the
    same tokens within ``LOGITS_TOL``; the planted fault (every GEMM with a
    DP region drops its last K chunk) on the prefill; the decode breakdown
    beside the weight-read floor."""
    import torch

    from repro_torch.core.gemm import gemm_context
    from repro_torch.core.selector import default_selector
    from repro_torch.kernels.common import LAUNCHES, count_launches, reset_launch_counts

    t0 = time.perf_counter()
    cfg = model.cfg
    arch, tol, n = cfg.name, LOGITS_TOL[cfg.name], WHISPER_REQUESTS
    gen = torch.Generator(device="cuda").manual_seed(1)
    frames = torch.randn(n, cfg.enc_frames, cfg.d_model, generator=gen, device="cuda").to(
        torch.bfloat16)
    prompts = torch.as_tensor(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (n, WHISPER_PROMPT)), device="cuda")
    selector = default_selector("cuda")
    reset_launch_counts()
    with gemm_context(selector=selector, backend="cuda") as ctx:
        t1 = time.perf_counter()
        first, cache = model.prefill(params, frames, prompts, max_seq=MAX_SEQ)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        steps, fed = _greedy_steps(model, params, cache, first, WHISPER_PROMPT, WHISPER_STEPS)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t1
    launches = {name: c for name, c in LAUNCHES.items() if c}
    needed = set()
    for e in ctx.log:
        needed |= _kernels_of(e)
    unlaunched = sorted(name for name in needed if not launches.get(name))
    if unlaunched:
        failures.append(f"{arch}: {unlaunched} were selected but never launched")
    got = [first.float()] + steps
    tokens = torch.cat(fed + [got[-1][:, -1].argmax(-1, keepdim=True)], dim=1)
    if not ((tokens >= 0) & (tokens < cfg.vocab_size)).all():
        failures.append(f"{arch}: bad tokens {tokens.tolist()}")

    with gemm_context(backend="torch"):
        want_first, tcache = model.prefill(params, frames, prompts, max_seq=MAX_SEQ)
        want_steps, _ = _greedy_steps(model, params, tcache, want_first, WHISPER_PROMPT,
                                      WHISPER_STEPS, fed=fed)
    del tcache
    want = [want_first.float()] + want_steps
    readings = _held_steps(f"{arch} prefill and decode", got, want, tol, failures)
    scale = want[0].abs().max().item()
    fault, _ = planted_fault_diff(model, params, selector, None, want[0], grouped=False, b1=True,
                                  prefill=lambda: model.prefill(params, frames, prompts)[0])
    if fault < 3 * tol * scale:
        failures.append(f"{arch}: a planted fault must read at least 3x the limit: max|diff| "
                        f"{fault:.4f} < 3 * {tol} * {scale:.4f}")

    # one warm decode step, broken down, on the cuda run's cache (it rewrites one row)
    tok, cur = fed[0], torch.full((n,), WHISPER_PROMPT + WHISPER_STEPS, device="cuda")
    with count_launches() as dec, gemm_context(selector=selector, backend="cuda") as dctx:
        model.decode_step(params, cache, tok, cur)
    breakdown = {}
    for backend in ("cuda", "torch"):
        with gemm_context(selector=selector, backend=backend):
            breakdown[backend] = decode_breakdown(
                lambda: model.decode_step(params, cache, tok, cur))
    del cache
    weight_bytes = _gemm_weight_bytes(model, params)
    floor_ms = weight_bytes / HBM_BW * 1e3
    for backend, bd in breakdown.items():
        log(f"{arch} warm decode step, {backend} backend: {bd['step_ms']:.2f} ms wall, "
            f"{bd['enqueue_ms']:.2f} ms host enqueue, device busy {bd['device_busy_ms']} ms "
            f"(GEMM kernels {bd['gemm_kernels_ms']} ms), idle share {bd['idle_share']}")
        for name, ms in bd["top_kernels"]:
            log(f"    {ms:9.3f} ms  {name}")
    if breakdown["cuda"]["fixup_ms"]:
        failures.append(f"{arch}: a fix-up kernel ran in a traced decode step")
    per = {name: dec.count(name) for name in sorted(set(dec))}
    picks = {}
    for e in ctx.log:
        s = e.selection
        picks.setdefault(f"{e.tag} {e.local_mnk} {e.op.in_dtype}",
                         f"{s.policy.name}/{s.cfg.name}/g{s.g}")
    step_ms = decode_s / WHISPER_STEPS * 1e3
    log(f"{arch}: {n} requests x {cfg.enc_frames} frames + {WHISPER_PROMPT} prompt tokens, "
        f"prefill {prefill_s:.2f}s, {WHISPER_STEPS} decode steps at {step_ms:.2f} ms (weight-read "
        f"floor {floor_ms:.2f} ms); launches {launches}; per decode step {per} "
        f"({len(dctx.log)} GEMM dispatches)")
    log(f"{arch} logits vs the torch backend fed the same tokens, max|diff| x max|logit| per "
        f"step {[f'{r:.2e}' for r in readings]} (limit {tol}); planted fault {fault:.4f} "
        f"({fault / scale:.3e} x max|logit|, must be >= {3 * tol * scale:.4f}); tokens "
        f"{tokens.tolist()}")
    for key, val in sorted(picks.items()):
        log(f"  {key} -> {val}")
    return dict(arch=arch, requests=n, frames=cfg.enc_frames, prompt_len=WHISPER_PROMPT,
                decode_steps=WHISPER_STEPS, prefill_s=prefill_s,
                prefill_tok_s=n * (cfg.enc_frames + WHISPER_PROMPT) / prefill_s,
                decode_s=decode_s, decode_step_ms=step_ms,
                decode_tok_s=n * WHISPER_STEPS / decode_s, decode_floor_ms=floor_ms,
                weight_bytes=weight_bytes, launches=launches, launches_per_decode_step=per,
                dispatches_per_decode_step=len(dctx.log), decode_breakdown=breakdown,
                step_readings=readings, logits_tol=tol, logits_max_abs=scale,
                planted_fault_max_abs_diff=fault, tokens=tokens.tolist(), picks=picks,
                seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# Phase 8: training
# ---------------------------------------------------------------------------

#: the trained cells: (arch, layers kept of the full depth), full width
#: (arch, layers): cut from 8 and 4 in PR 32 to make room for phase 12 in the time limit
TRAIN_CELLS = (("granite-8b", 4), ("olmoe-1b-7b", 2))
TRAIN_SEQ = 4096  # repro's train_4k sequence, one row (its global batch 256 cut to 1)
TRAIN_STEPS = 6  # Trainer.fit on one repeated batch
STREAM_STEPS = 4  # Trainer.fit on the stream, checkpointed every 2 steps
#: one step's loss, the cuda path against the torch backend (relative)
TRAIN_LOSS_TOL = 1e-2
#: the whole gradient tree, the cuda path against the torch backend (relative L2)
TRAIN_GRAD_TOL = 3e-2
#: the resumed run's losses against the uninterrupted run's (relative)
RESUME_TOL = 1e-3
#: the layers of the checkpointed stream run, at full width: one checkpoint
#: (bf16 params, f32 master, mu and nu) of 8 layers is 30 GB, and a call on
#: the card may write 45 GiB in all, deletions included
RESUME_LAYERS = 1


class RestoreOnly:
    """A ``CheckpointManager`` for the resumed run: it restores, and writes
    nothing (the card's machine allows one checkpoint write a model)."""

    def __init__(self, manager):
        self.manager = manager

    def __getattr__(self, name):
        return getattr(self.manager, name)

    def save(self, *args, **kwargs):
        pass


class RepeatedBatch:
    """A data stream whose every step is ``data``'s batch 0 (the repeated
    batch, on which the loss must fall); its state is ``data``'s."""

    def __init__(self, data):
        self.data = data

    @property
    def state(self):
        return self.data.state

    def batch_at(self, step):
        return self.data.batch_at(0)

    def state_dict(self):
        return self.data.state_dict()

    def load_state_dict(self, d):
        self.data.load_state_dict(d)


def _grad_step(model, params, batch, backend=None, selector=None):
    """One forward and backward on ``backend`` (None: the cuda kernels with
    ``GemmGrad``): the loss, {leaf path: gradient or None} (the leaves'
    ``.grad`` cleared), the selection log, how many of its entries the
    forward made, the launches of the forward and of the backward by
    counter, and the forward's and the backward's ms (CUDA events)."""
    import torch

    from repro_torch.core.gemm import gemm_context
    from repro_torch.kernels.common import LAUNCHES, reset_launch_counts
    from repro_torch.utils.trees import tree_items

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    with gemm_context(selector=selector, backend=backend) as ctx:
        reset_launch_counts()
        ev[0].record()
        loss, _ = model.loss_fn(params, batch)
        ev[1].record()
        torch.cuda.synchronize()
        fwd, n_fwd = {k: v for k, v in LAUNCHES.items() if v}, len(ctx.log)
        reset_launch_counts()
        loss.backward()
        ev[2].record()
        torch.cuda.synchronize()
        bwd, entries = {k: v for k, v in LAUNCHES.items() if v}, list(ctx.log)
    grads = {}
    for name, p in tree_items(params):
        grads[name], p.grad = p.grad, None
    return dict(loss=loss.item(), grads=grads, log=entries, n_fwd=n_fwd, fwd=fwd, bwd=bwd,
                fwd_ms=ev[0].elapsed_time(ev[1]), bwd_ms=ev[1].elapsed_time(ev[2]))


def ksplit_backend(parts):
    """A sound variant of the ``torch`` backend that sums K in ``parts`` f32
    slices (the same function, another summation order): how far two
    correct implementations' gradients lie apart."""
    import torch

    from repro_torch.core.gemm import as_dtype

    def backend(x, w, *, op, policy, cfg, g, bias, operand, **kw):
        k = x.shape[-1]
        cut = [k * i // parts for i in range(parts + 1)]
        acc = sum(torch.matmul(x[..., a:b].float(), w[:, a:b].float())
                  for a, b in zip(cut, cut[1:]))
        acc = op.epilogue.apply(acc, bias=None if bias is None else bias[:, None, :],
                                operand=operand)
        return acc.to(as_dtype(op.out_dtype))

    return backend


def _grad_diff(grads, want):
    """(the tree's relative L2 distance, [the worst leaf, its relative L2
    distance]) of ``grads`` from ``want``, in f32; a missing gradient reads
    as zeros."""
    num = den = 0.0
    worst = ["", 0.0]
    for name, w in want.items():
        g, wf = grads.get(name), w.float()
        d2 = (wf if g is None else g.float() - wf).square().sum().item()
        w2 = wf.square().sum().item()
        num, den = num + d2, den + w2
        rel = math.sqrt(d2 / max(w2, 1e-30))
        if rel > worst[1]:
            worst = [name, rel]
    return math.sqrt(num / max(den, 1e-30)), worst


@contextmanager
def routing_by_layer(record=None, replay=None):
    """Record (into the dict ``record``) or replay (from ``replay``) each MoE
    layer's top-k expert choice, keyed by the address of the layer's router
    weight (a view into the stacked router, so a layer's forward and its
    remat recompute share the key); replayed gates are the layer's own
    probabilities at the recorded experts."""
    import torch

    from repro_torch.models import layers

    moe_apply = layers.moe_apply

    def wrapped(p, x, cfg, *, div):
        key, topk = p["router"].data_ptr(), torch.topk

        def choose(probs, k, dim=-1):
            if replay is not None:
                idx = replay[key]
                return probs.gather(dim, idx), idx
            vals, idx = topk(probs, k, dim=dim)
            record.setdefault(key, idx)
            return vals, idx

        torch.topk = choose
        try:
            return moe_apply(p, x, cfg, div=div)
        finally:
            torch.topk = topk

    layers.moe_apply = wrapped
    try:
        yield
    finally:
        layers.moe_apply = moe_apply


@contextmanager
def gate_term_dropped():
    """The planted fault: ``GemmGrad``'s backward loses the ``mul_silu``
    gate's term (no gradient reaches the operand), so the gate projections
    get none and every layer below loses that path's share of dX."""
    from repro_torch.core import gemm as gemm_mod

    real = gemm_mod.GemmGrad.backward

    def backward(ctx, dout):
        grads = list(real(ctx, dout))
        if ctx.kwargs["op"].epilogue.binary == "mul_silu":
            grads[3] = None
        return tuple(grads)

    gemm_mod.GemmGrad.backward = staticmethod(backward)
    try:
        yield
    finally:
        gemm_mod.GemmGrad.backward = staticmethod(real)


def _op_counts(entries):
    """(tag, op key) -> [its first entry, its dispatches] over a log."""
    out = {}
    for e in entries:
        out.setdefault((e.tag, e.op.key), [e, 0])[1] += 1
    return out


def _kernel_counts(entries):
    """The launches the selections of ``entries`` call for, by counter."""
    counts = {}
    for e in entries:
        for name in _kernels_of(e):
            counts[name] = counts.get(name, 0) + 1
    return counts


def train_gemm_check(entries, gen):
    """Each forward GEMM of a training step (one per (tag, op key)) at its
    training shape and pick: the kernel against the ``torch`` backend's f32
    formula with the op's epilogue on seeded operands (2e-2 bf16, 1e-4 f32),
    then its device ms beside the library call of the same product
    (``torch.matmul``, batched for the grouped ops; f32 for the router) and
    the bound, and the two f32 ``torch.matmul`` products of its backward
    (dX, dW) timed at the same shapes."""
    import torch

    from repro_torch.core.gemm import as_dtype, get_backend

    cuda, ref_fn = get_backend("cuda"), get_backend("torch")
    rows = []
    for (tag, key), (e, n) in _op_counts(entries).items():
        op, s = e.op, e.selection
        g, m, nn, k = op.g, op.m, op.n, op.k
        dt = as_dtype(op.in_dtype)
        a = torch.randn(g, m, k, generator=gen, device="cuda").to(dt)
        b = (torch.randn(g, k, nn, generator=gen, device="cuda") / math.sqrt(k)).to(dt)
        operand = (torch.randn(g, m, nn, generator=gen, device="cuda").to(dt)
                   if op.epilogue.binary != "none" else None)
        kw = dict(op=op, policy=s.policy, cfg=s.cfg, g=s.g, bias=None, operand=operand)
        tol = 2e-2 if dt == torch.bfloat16 else 1e-4
        err = close(cuda(a, b, **kw), ref_fn(a, b, **kw), tol, f"train {tag} {key}")
        ms, _ = time_ms(lambda: cuda(a, b, **kw), iters=5, warmup=1)
        lib, _ = time_ms(lambda: torch.matmul(a, b), iters=5, warmup=1)
        af, bf = a.float(), b.float()
        dacc = torch.randn(g, m, nn, generator=gen, device="cuda")
        dx_ms, _ = time_ms(lambda: torch.matmul(dacc, bf.transpose(1, 2)), iters=5, warmup=1)
        dw_ms, _ = time_ms(lambda: torch.matmul(af.transpose(1, 2), dacc), iters=5, warmup=1)
        nbytes = g * (m * k + k * nn + m * nn * (2 if operand is not None else 1)) \
            * a.element_size()
        bnd, by = bound_ms(nbytes, 2 * g * m * nn * k,
                           peak=PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32)
        rows.append(dict(tag=tag, key=list(key), g=g, m=m, n=nn, k=k, dtype=op.in_dtype,
                         epilogue=op.epilogue.name, policy=s.policy.name, tile=s.cfg.name,
                         sel_g=s.g, dispatches=n, kernels=sorted(_kernels_of(e)),
                         max_abs_err=err, ms=ms, library_ms=lib, bound_ms=bnd, bound_by=by,
                         bwd_dx_ms=dx_ms, bwd_dw_ms=dw_ms))
        log(f"  train gemm {tag} {g}x{m}x{nn}x{k} {op.in_dtype} {op.epilogue.name} "
            f"{s.policy.name}/{s.cfg.name} g={s.g} x{n}: err {err:.2e}, {ms:.4f} ms "
            f"(torch.matmul {lib:.4f}, bound {bnd:.4f} by {by}); backward f32 dX {dx_ms:.4f}, "
            f"dW {dw_ms:.4f} ms")
        del a, b, af, bf, dacc, operand
    torch.cuda.empty_cache()
    return rows


def _split_step(model, opt, state, batch):
    """One more training step timed by CUDA events in three parts (forward,
    backward, optimizer), then one traced by ``torch.profiler``: the device
    ms of the hand-written GEMM kernels, of the library's GEMMs (the f32
    attention einsums and the backward's f32 products) and of the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.trainer import take_grads

    def step(ev=None):
        def mark(i):
            if ev:
                ev[i].record()

        mark(0)
        loss, _ = model.loss_fn(state["params"], batch)
        mark(1)
        loss.backward()
        mark(2)
        opt.update(take_grads(state["params"]), state["opt"], state["params"])
        state["step"] = state["step"] + 1
        mark(3)

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(ev)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    by_name = device_ms_by_name(prof)
    ours = sum(v for n, v in by_name.items() if any(f in n for f in GEMM_KERNELS))
    lib = sum(v for n, v in by_name.items()
              if "gemm" in n.lower() and not any(f in n for f in GEMM_KERNELS))
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(step_ms=wall, forward_ms=ev[0].elapsed_time(ev[1]),
                backward_ms=ev[1].elapsed_time(ev[2]), optimizer_ms=ev[2].elapsed_time(ev[3]),
                # None when the trace holds no device events ("not measured")
                device_busy_ms=busy or None, gemm_kernels_ms=ours if busy else None,
                library_gemm_ms=lib if busy else None, other_ms=busy - ours - lib if busy else None,
                top_kernels=[[n[:90], v] for n, v in top])


def _state_bits(state):
    """{leaf path: a CPU copy of its bits} (bf16 as int16)."""
    import torch

    from repro_torch.utils.trees import tree_items

    return {name: (t.detach().view(torch.int16) if t.dtype == torch.bfloat16 else t.detach())
            .to("cpu", copy=True) for name, t in tree_items(state)}


def _fresh_state(model, opt):
    """The train state of the seeded weights (the generator seeded 0)."""
    import torch

    from repro_torch.train import init_train_state

    params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
    return init_train_state(model, opt, params)


def _free():
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def train_cell(arch, layers, failures):
    """Phase 8 for one model (see the module docstring). Returns its record."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.gemm import register_backend
    from repro_torch.core.selector import default_selector
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels.common import LAUNCHES, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.trainer import to_device_batch
    from repro_torch.utils.trees import tree_count, tree_items

    t_cell = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    model, moe = build_model(cfg), cfg.family == "moe"
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
    rec = dict(layers=layers, n_params=tree_count(params), param_count=cfg.param_count(),
               active_params=cfg.active_param_count())
    log(f"train {arch} x {layers} layers: {rec['n_params'] / 1e9:.3f} B parameters "
        f"(cfg.param_count() {cfg.param_count() / 1e9:.3f} B)")
    if rec["n_params"] != cfg.param_count():
        failures.append(f"train {arch}: {rec['n_params']} parameters instantiated, "
                        f"cfg.param_count() {cfg.param_count()}")
    data = SyntheticLMData(cfg, batch=1, seq_len=TRAIN_SEQ, seed=0)
    batch = to_device_batch(data.batch_at(0), "cuda")
    for _, p in tree_items(params):
        p.requires_grad_(True)

    # -- one step's gradients: the kernels forward with GemmGrad's backward,
    # against autograd through the torch backend (olmoe's routing replayed)
    routes = {}
    with routing_by_layer(record=routes) if moe else nullcontext():
        run = _grad_step(model, params, batch, selector=default_selector("cuda"))
    fwd_log, bwd_log = run["log"][: run["n_fwd"]], run["log"][run["n_fwd"]:]
    remat = _kernel_counts(bwd_log)
    rec["launches_step"] = dict(
        forward=run["fwd"], backward=run["bwd"], remat_recompute=remat,
        accumulator_recompute={k: v - remat.get(k, 0) for k, v in run["bwd"].items()},
        forward_dispatches=len(fwd_log), remat_dispatches=len(bwd_log))
    rec["picks"] = {f"{tag} {list(key)}": [e.selection.policy.name, e.selection.cfg.name,
                                           e.selection.g, n]
                    for (tag, key), (e, n) in _op_counts(fwd_log).items()}
    missing = [name for name, g in run["grads"].items() if g is None]
    if missing:
        failures.append(f"train {arch}: no gradient reached {missing}")
    with routing_by_layer(replay=routes) if moe else nullcontext():
        ref = _grad_step(model, params, batch, backend="torch")
    loss_rel = abs(run["loss"] - ref["loss"]) / abs(ref["loss"])
    grad_rel, worst = _grad_diff(run["grads"], ref["grads"])
    rec["grads"] = dict(loss_cuda=run["loss"], loss_torch=ref["loss"], loss_rel=loss_rel,
                        tree_rel_l2=grad_rel, worst_leaf=worst,
                        routing="replayed" if moe else None, every_leaf=not missing,
                        cuda_forward_ms=run["fwd_ms"], cuda_backward_ms=run["bwd_ms"],
                        torch_forward_ms=ref["fwd_ms"], torch_backward_ms=ref["bwd_ms"])
    # the spread between sound implementations: the torch backend summing K
    # in two halves, against the torch backend (reported)
    register_backend("torch_ksplit2", ksplit_backend(2), overwrite=True)
    with routing_by_layer(replay=routes) if moe else nullcontext():
        variant = _grad_step(model, params, batch, backend="torch_ksplit2")
    rec["grads"]["sound_variant_tree_rel_l2"] = _grad_diff(variant["grads"], ref["grads"])[0]
    rec["grads"]["sound_variant_loss_rel"] = abs(variant["loss"] - ref["loss"]) / abs(ref["loss"])
    del variant
    if moe:  # the torch backend routing on its own: reported
        own = _grad_step(model, params, batch, backend="torch")
        rec["grads"]["own_routing_tree_rel_l2"] = _grad_diff(run["grads"], own["grads"])[0]
        rec["grads"]["own_routing_loss_rel"] = abs(run["loss"] - own["loss"]) / abs(own["loss"])
        del own
    del run
    # the planted fault, read as the limit is held
    with gate_term_dropped(), routing_by_layer(replay=routes) if moe else nullcontext():
        bad = _grad_step(model, params, batch)
    fault = _grad_diff(bad["grads"], ref["grads"])[0]
    del bad, ref
    rec["grads"].update(fault="mul_silu VJP with the gate's term dropped",
                        fault_tree_rel_l2=fault)
    log(f"train {arch}: loss cuda {rec['grads']['loss_cuda']:.5f}, torch "
        f"{rec['grads']['loss_torch']:.5f} (rel {loss_rel:.2e}); gradient tree rel L2 "
        f"{grad_rel:.3e}, worst leaf {worst[0]} {worst[1]:.3e} (a sound variant, K summed in "
        f"two halves: {rec['grads']['sound_variant_tree_rel_l2']:.3e}); planted fault (gate term "
        f"dropped) {fault:.3e}; launches a step {rec['launches_step']}")
    if not loss_rel <= TRAIN_LOSS_TOL:
        failures.append(f"train {arch}: loss rel {loss_rel:.3e} > {TRAIN_LOSS_TOL}")
    if not grad_rel <= TRAIN_GRAD_TOL:
        failures.append(f"train {arch}: gradient tree rel L2 {grad_rel:.3e} > {TRAIN_GRAD_TOL}")
    if not fault >= 3 * TRAIN_GRAD_TOL:
        failures.append(f"train {arch}: planted fault reads {fault:.3e} < 3 x {TRAIN_GRAD_TOL}")
    rec["grad_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # -- the forward GEMMs at their training shapes, held and timed
    rec["gemms"] = train_gemm_check(fwd_log, torch.Generator(device="cuda").manual_seed(1))
    rec["gemm_ms_step"] = sum(r["ms"] * r["dispatches"] for r in rec["gemms"])
    rec["library_ms_step"] = sum(r["library_ms"] * r["dispatches"] for r in rec["gemms"])
    rec["backward_products_ms_step"] = sum((r["bwd_dx_ms"] + r["bwd_dw_ms"]) * r["dispatches"]
                                           for r in rec["gemms"])
    del params
    _free()

    def optimizer(steps):
        return make_optimizer("adamw", warmup_cosine(3e-4, 2, steps))

    # -- the main path: Trainer.fit on one repeated batch, its launches counted
    torch.cuda.reset_peak_memory_stats()
    opt = optimizer(TRAIN_STEPS)
    state = _fresh_state(model, opt)
    trainer = Trainer(model, opt, RepeatedBatch(data),
                      TrainerConfig(total_steps=TRAIN_STEPS, log_every=1))
    reset_launch_counts()
    t0 = time.perf_counter()
    state = trainer.fit(state)
    fit_s = time.perf_counter() - t0
    launches = rec["fit_launches"] = {k: v for k, v in LAUNCHES.items() if v}
    hist = trainer.history
    rec["repeated"] = dict(history=hist, seconds=fit_s, ewma_step_s=trainer.monitor.ewma.mean,
                           stragglers=trainer.monitor.flagged)
    log(f"train {arch}: repeated batch, {TRAIN_STEPS} steps in {fit_s:.1f}s: {hist}; "
        f"launches {launches}")
    if not all(math.isfinite(x) for x in hist) or not hist[-1] < hist[0]:
        failures.append(f"train {arch}: repeated-batch losses must be finite and fall: {hist}")
    b5 = sum(n for name, n in launches.items() if name.startswith("grouped"))
    if moe:
        # the f32 router runs the kernels its pick calls for at M = 4096 (the
        # H100 cost model picks DP there: B1 on the f32 FMA loop; B2 at decode)
        router = [e for e in fwd_log if e.tag == "moe.router"]
        rec["router_kernels"] = sorted(set().union(*map(_kernels_of, router)))
        if not b5 or not router or not all(launches.get(k) for k in rec["router_kernels"]):
            failures.append(f"train {arch}: B5 and the router's kernels "
                            f"{rec['router_kernels']} must launch: {launches}")
    elif b5 or not (launches.get("dp_gemm_region") or launches.get("streamk_phase1")):
        failures.append(f"train {arch}: B1 and/or B2 must launch and B5 must not: {launches}")
    split = rec["split"] = _split_step(model, opt, state, batch)
    rec["train_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    step_s = split["step_ms"] / 1e3
    split["mfu"] = 6 * rec["n_params"] * TRAIN_SEQ / step_s / PEAK_BF16
    split["mfu_active"] = 6 * rec["active_params"] * TRAIN_SEQ / step_s / PEAK_BF16
    log(f"train {arch}: a step {split['step_ms']:.1f} ms (forward {split['forward_ms']:.1f}, "
        f"backward {split['backward_ms']:.1f}, optimizer {split['optimizer_ms']:.1f}); device "
        f"ms: GEMM kernels {split['gemm_kernels_ms']}, library GEMMs "
        f"{split['library_gemm_ms']}, other {split['other_ms']}; 6NT / step / 989 TFLOP/s = "
        f"{split['mfu']:.4f}; peak {rec['train_peak_gb']:.2f} GB")
    del state, trainer
    _free()

    # -- the stream, at RESUME_LAYERS: uninterrupted; then checkpointed every
    # 2 steps with a crash after step 2, and a fresh trainer resuming from
    # that checkpoint
    del model
    _free()
    cfg = dataclasses.replace(cfg, n_layers=RESUME_LAYERS)
    model = build_model(cfg)

    def stream_trainer(**kw):
        opt = optimizer(STREAM_STEPS)
        tcfg = TrainerConfig(total_steps=STREAM_STEPS, log_every=1, ckpt_every=2, ckpt_keep=1,
                             async_ckpt=False, ckpt_dir=kw.pop("ckpt_dir", None))
        data = SyntheticLMData(cfg, batch=1, seq_len=TRAIN_SEQ, seed=0)
        return opt, Trainer(model, opt, data, tcfg, **kw)

    opt, t_u = stream_trainer()
    t_u.fit(_fresh_state(model, opt))
    _free()
    with tempfile.TemporaryDirectory(prefix=".train_ckpt_", dir=ROOT) as d:

        def crash(step):
            if step == 2:
                raise RuntimeError("injected after step 2")

        opt, t_b = stream_trainer(ckpt_dir=d, failure_injector=crash)
        state = _fresh_state(model, opt)
        t0 = time.perf_counter()
        try:
            t_b.fit(state)
            failures.append(f"train {arch}: the injected failure did not fire")
        except RuntimeError as e:
            if "injected" not in str(e):
                raise
        crash_s = time.perf_counter() - t0
        saved = _state_bits(state)  # the state the step-2 checkpoint holds
        del state, t_b
        _free()
        seen = {}

        def check_restored(step):  # called before each step: the first sees the restore
            if not seen:
                seen.update(step=step, s=time.perf_counter() - t0)
                now = dict(tree_items(state))
                seen["differ"] = [n for n in saved
                                  if not torch.equal(saved[n], _state_bits({"x": now[n]})["x"])]

        opt, t_c = stream_trainer(ckpt_dir=d, failure_injector=check_restored)
        t_c.ckpt = RestoreOnly(t_c.ckpt)
        state = _fresh_state(model, opt)
        t0 = time.perf_counter()
        t_c.fit(state)  # restores IN PLACE into ``state``
        resumed_s = time.perf_counter() - t0
        del saved, state
        ckpt_bytes = sum(os.path.getsize(os.path.join(dp, f))
                         for dp, _, fs in os.walk(d) for f in fs)
    u, c, step = t_u.history, t_c.history, seen.get("step")
    rel = [abs(a - b) / abs(b) for a, b in zip(c, u[2:])]
    rec["stream"] = dict(layers=RESUME_LAYERS, history=u, resumed_at_step=step, resumed=c,
                         resumed_rel=rel,
                         bitwise=c == u[2:], restored_differ=seen.get("differ"),
                         crash_run_s=crash_s, restore_s=seen.get("s"), resumed_run_s=resumed_s,
                         checkpoint_gb=ckpt_bytes / 1e9)
    log(f"train {arch} x {RESUME_LAYERS} layer(s): stream {u}; resumed at step {step}: {c} "
        f"(rel {rel}, bitwise "
        f"{c == u[2:]}); restored leaves that differ from the saved state: "
        f"{seen.get('differ')}; one checkpoint {ckpt_bytes / 1e9:.2f} GB; crash run "
        f"{crash_s:.1f}s, restore {seen.get('s', 0):.1f}s, resumed run {resumed_s:.1f}s")
    if step != 2 or seen.get("differ") or len(c) != 2 or not all(r <= RESUME_TOL for r in rel):
        failures.append(f"train {arch}: the resume from step 2: at step {step}, leaves that "
                        f"differ {seen.get('differ')}, losses {c} against {u[2:]}")
    if not all(math.isfinite(x) for x in u + c):
        failures.append(f"train {arch}: non-finite stream losses {u} {c}")
    del t_c, t_u, model
    _free()
    rec["seconds"] = time.perf_counter() - t_cell
    log(f"train {arch}: {rec['seconds']:.1f}s")
    return rec


def phase_train(failures):
    """Phase 8: train granite-8b and olmoe-1b-7b at full width with their
    depth cut (``TRAIN_CELLS``), one model on the card at a time. Returns
    each model's record by arch."""
    t0 = time.perf_counter()
    out = {arch: train_cell(arch, layers, failures) for arch, layers in TRAIN_CELLS}
    log(f"phase 8 (training): {time.perf_counter() - t0:.1f}s")
    return out


# ---------------------------------------------------------------------------
# Phase 9: sharding plans, the dry run, the per-shard GEMMs, the MoE variants
# ---------------------------------------------------------------------------

#: the models whose every applicable cell is traced on both production meshes
#: and whose per-shard GEMMs run on the card; the other configs are traced at
#: decode_32k on the single-pod mesh
DRYRUN_ARCHS = ("granite-8b", "olmoe-1b-7b")
PER_SHARD_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
#: olmoe-1b-7b served on the mesh-aware MoE dispatches: (moe_impl, div); the
#: 4 slots route as 4 token groups under the sharded one
MOE_VARIANTS = (("sharded", {"batch": 4, "model": 1}), ("hinted", None))


def dryrun_cells():
    """(arch, shape, multi_pod) of phase 9 (a), in run order."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.models import applicable_shapes

    cells = [(arch, shape.name, mp) for arch in DRYRUN_ARCHS
             for shape in applicable_shapes(get_config(arch)) for mp in (False, True)]
    return cells + [(arch, "decode_32k", False) for arch in list_archs()
                    if arch not in DRYRUN_ARCHS]


def dryrun_worker(path):
    """Phase 9 (a)'s traces, in a process of their own (they need no card,
    so they run while the kernels build): ``lower_cell`` of every cell of
    ``dryrun_cells()`` on the meta device; the artifacts go to ``path``."""
    from repro_torch.launch.dryrun import lower_cell

    out = []
    for arch, shape, mp in dryrun_cells():
        t0 = time.perf_counter()
        try:
            art = lower_cell(arch, shape, mp)
        except Exception as e:  # reported as the cell's status, checked in phase 9
            art = dict(arch=arch, shape=shape, mesh="multi_pod" if mp else "single_pod",
                       status="error", error=f"{type(e).__name__}: {e}"[:2000])
        art["seconds"] = time.perf_counter() - t0
        print(f"dry run {arch} {shape} {art['mesh']}: {art['status']} "
              f"({art['seconds']:.1f}s)", flush=True)
        out.append(art)
    Path(path).write_text(json.dumps(out))
    # phase 13's cells, each under the rules its rank parts run
    phase13_dryrun(Path(path).with_name("phase13_dryrun.json"))


def start_dryrun():
    """Start phase 9 (a)'s dry run in a child process (no card: CUDA hidden
    from it); returns (the process, its artifacts' path)."""
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    path = out_dir / "phase9_dryrun.json"
    for stale in (path, path.with_name("phase13_dryrun.json")):
        if stale.exists():
            stale.unlink()
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; "
            f"chip_smoke.dryrun_worker({str(path)!r})")
    logf = open(out_dir / "phase9_dryrun.log", "w")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=logf,
                            stderr=subprocess.STDOUT,
                            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    logf.close()
    return proc, path


def dispatch_problems(art):
    """What is wrong with one cell's dispatch table: every plain GEMM's M
    divided by the cell's ``div["batch"]`` and N or K (or neither: the
    router) by ``div["model"]``, every grouped GEMM's experts by
    ``div["model"]``, each ``local_mnk`` the global dims over those divisors
    and its key ``tag:local_mnk``; and the FLOP identity (the dispatch's
    share of ``FlopCounterMode``'s count equals 2 G M N K over the log)."""
    div = art["config"]["div"]
    db, dm = div["batch"], div["model"]
    out = []
    for key, e in art["dispatch"].items():
        d = tuple(e["divisors"])
        if e["kind"] == "grouped":
            ok = d == (1, 1, 1) and e["g_divisor"] == dm and (
                e["groups"] == max(1, e["global_groups"] // dm))
        else:
            ok = d in ((db, dm, 1), (db, 1, dm), (db, 1, 1))
        local = [max(1, g // x) for g, x in zip(e["global_mnk"], d)]
        tag = key.rsplit(":", 1)[0]
        if not ok or e["local_mnk"] != local or key != f"{tag}:{tuple(local)}":
            out.append(f"{key}: divisors {d}, g_divisor {e['g_divisor']}, global "
                       f"{e['global_mnk']} x {e['global_groups']} under div {div}")
    if art["cost"]["gemm_flops"] != art["cost"]["gemm_flops_logged"]:
        out.append(f"FLOP identity: the dispatch ran {art['cost']['gemm_flops']:.6e}, its log "
                   f"asks for {art['cost']['gemm_flops_logged']:.6e}")
    return out


def phase_dryrun(proc, path, failures):
    """Phase 9 (a): wait for the dry run started with the build, log each
    cell (status, unique GEMMs, per-device argument GB, FLOPs, seconds) and
    hold every cell to ``ok`` and ``dispatch_problems``; two planted faults
    (a divisor off by one shard factor, a doubled M in one log entry) must
    be caught."""
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        failures.append("phase 9 (a): the dry run did not finish in 600 s")
        return None
    waited = time.perf_counter() - t0
    if rc != 0 or not path.exists():
        failures.append(f"phase 9 (a): the dry run exited {rc} "
                        "(chiprun_out/phase9_dryrun.log)")
        return None
    arts = json.loads(path.read_text())
    want = dryrun_cells()
    cells = [(a["arch"], a["shape"], a["mesh"] == "multi_pod") for a in arts]
    if cells != want:
        failures.append(f"phase 9 (a): traced cells {cells} != {want}")
    for art in arts:
        label = f"dry run {art['arch']} {art['shape']} {art['mesh']}"
        if art["status"] != "ok":
            failures.append(f"{label}: {art['status']} {art.get('error', art.get('reason'))}")
            continue
        problems = dispatch_problems(art)
        failures.extend(f"{label}: {p}" for p in problems)
        log(f"{label}: ok, {len(art['dispatch'])} unique GEMMs ({art['dispatches']} "
            f"dispatches), div {art['config']['div']}, argument "
            f"{art['memory']['argument_size'] / 1e9:.3f} GB a device, {art['cost']['flops']:.4e} "
            f"FLOPs (GEMMs {art['cost']['gemm_flops']:.4e} = 2GMNK over the log: "
            f"{not problems}), {art['seconds']:.1f}s")
    # the planted faults: a cell whose table claims the wrong split, and one
    # whose log claims a GEMM twice the size of the one that ran
    ok = [a for a in arts if a["status"] == "ok" and a["dispatch"]]
    faults = {}
    if ok:
        bad = json.loads(json.dumps(ok[0]))
        bad["config"]["div"]["batch"] *= 2
        faults["div"] = len(dispatch_problems(bad))
        bad = json.loads(json.dumps(ok[0]))
        e = next(iter(bad["dispatch"].values()))
        bad["cost"]["gemm_flops_logged"] += 2 * e["global_groups"] * math.prod(e["global_mnk"])
        faults["flops"] = len(dispatch_problems(bad))
    log(f"phase 9 (a) planted faults (problems found; each must be > 0): {faults}")
    if not faults or not all(faults.values()):
        failures.append(f"phase 9 (a): a planted fault went unseen: {faults}")
    log(f"phase 9 (a): {len(arts)} cells traced in {sum(a['seconds'] for a in arts):.1f}s "
        f"(beside the build); waited {waited:.1f}s after phase 8")
    return dict(cells=[{k: a.get(k) for k in ("arch", "shape", "mesh", "status", "memory",
                                               "cost", "seconds", "dispatches")}
                       | {"unique_gemms": len(a.get("dispatch", {})),
                          "div": a.get("config", {}).get("div")} for a in arts],
                planted_faults=faults, waited_s=waited, artifacts=arts)


def _epilogue_of(fields):
    from repro_torch.core.op import Epilogue

    return Epilogue(**fields)


def per_shard_gemms(arts):
    """The unique per-shard GEMMs of ``DRYRUN_ARCHS`` at ``PER_SHARD_SHAPES``
    on the single-pod mesh: (arch, shape, key, entry), one per (tag, local
    shape, groups, dtype, epilogue, selection)."""
    seen, out = set(), []
    for art in arts:
        if (art["status"] != "ok" or art["arch"] not in DRYRUN_ARCHS
                or art["shape"] not in PER_SHARD_SHAPES or art["mesh"] != "single_pod"):
            continue
        for key, e in art["dispatch"].items():
            uid = (key, e["groups"], e["in_dtype"], e["epilogue"], e["policy"], e["cfg"], e["g"])
            if uid not in seen:
                seen.add(uid)
                out.append((art["arch"], art["shape"], key, e))
    return out


def phase_shard_gemms(arts, gen, failures):
    """Phase 9 (b): each unique per-shard GEMM of the dry run at its local
    shape, on seeded operands made on the card, launched once through the
    ``cuda`` backend with the recorded selection (policy, tile, g) and held
    against the ``torch`` backend's f32 formula with the op's epilogue (2e-2
    bf16, 1e-4 for the f32 router), the launch counters zeroed just before
    and read just after (every kernel the selection calls for must launch);
    a planted fault (the last K chunk dropped, half of K where K <= bk)
    must read at least 3x the limit; then timed (``time_ms``; weights under
    200 MB rotated past the L2, for both) beside ``torch.matmul`` of the
    same operands and the bound. No GEMM may fall back: the ``cuda`` backend has no
    plain path on CUDA tensors, and a refused selection is a failure."""
    import itertools
    from types import SimpleNamespace

    import torch

    from repro_torch.core.gemm import as_dtype, get_backend
    from repro_torch.core.op import GemmOp
    from repro_torch.core.policies import ALL_POLICIES, TileConfig
    from repro_torch.core.selector import Selection
    from repro_torch.kernels.common import LAUNCHES, reset_launch_counts

    cuda, ref_fn = get_backend("cuda"), get_backend("torch")
    policies = {p.name: p for p in ALL_POLICIES}
    rows, launched = [], {}
    t_phase = time.perf_counter()
    for arch, shape, key, e in per_shard_gemms(arts):
        (m, n, k), g = e["local_mnk"], e["groups"]
        epi = _epilogue_of(e["epilogue_fields"])
        op = GemmOp(m, n, k, g=g, kind=e["kind"], in_dtype=e["in_dtype"],
                    out_dtype=e["out_dtype"], epilogue=epi, fused=e["fused"])
        policy, cfg = policies[e["policy"]], TileConfig(*e["tile"])
        label = f"shard gemm {arch} {shape} {key} G={g} {e['in_dtype']} {epi.name}"
        try:
            dt = as_dtype(e["in_dtype"])
            a = torch.randn(g, m, k, generator=gen, device="cuda").to(dt)
            b = (torch.randn(g, k, n, generator=gen, device="cuda") / math.sqrt(k)).to(dt)
            operand = (torch.randn(g, m, n, generator=gen, device="cuda").to(dt)
                       if epi.binary != "none" else None)
            bias = torch.randn(g, n, generator=gen, device="cuda").to(dt) if epi.bias else None
            kw = dict(op=op, policy=policy, cfg=cfg, g=e["g"], bias=bias, operand=operand)
            tol = 2e-2 if dt == torch.bfloat16 else 1e-4
            entry = SimpleNamespace(op=op, local_mnk=(m, n, k), selection=Selection(
                policy, cfg, "forced", 0, 0, e["g"]))
            needed = _kernels_of(entry)
            reset_launch_counts()
            got = cuda(a, b, **kw)
            torch.cuda.synchronize()
            counts = {name: c for name, c in LAUNCHES.items() if c}
            for name, c in counts.items():
                launched[name] = launched.get(name, 0) + c
            want = ref_fn(a, b, **kw)
            err = close(got, want, tol, label)
            missing = sorted(name for name in needed if not counts.get(name))
            if missing or set(counts) - set(needed):
                raise AssertionError(f"{label}: launched {counts}, the selection calls for "
                                     f"{sorted(needed)}")
            cut = cfg.bk if k > cfg.bk else k // 2
            bad = cuda(a[..., : k - cut].contiguous(), b[:, : k - cut].contiguous(), **kw)
            scale = max(1.0, want.float().abs().max().item())
            fault = (bad.float() - want.float()).abs().max().item() / scale
            del got, want, bad
            if fault < 3 * tol:
                raise AssertionError(f"{label}: the planted fault reads {fault:.3e} < 3 x {tol}")
            copies = _rotating(b) if b.numel() * b.element_size() < 200 * 2**20 else [b]
            it = itertools.cycle(copies)
            big = 2 * g * m * n * k > 2e11
            iters, warm = (5, 1) if big else (20, 3)
            ms, event_ms = time_ms(lambda: cuda(a, next(it), **kw), iters=iters, warmup=warm)
            lib, _ = time_ms(lambda: torch.matmul(a, next(it)), iters=iters, warmup=warm)
            nbytes = g * (m * k + k * n + m * n * (2 if operand is not None else 1)) \
                * a.element_size()
            bnd, by = bound_ms(nbytes, 2 * g * m * n * k,
                               peak=PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32)
            row = dict(arch=arch, shape=shape, key=key, groups=g, m=m, n=n, k=k,
                       dtype=e["in_dtype"], epilogue=epi.name, policy=policy.name,
                       tile=cfg.name, g=e["g"], kernels=sorted(needed), launches=counts,
                       max_abs_err=err, tol=tol, fault=fault, ms=ms, event_ms=event_ms,
                       library_ms=lib, bound_ms=bnd, bound_by=by)
            rows.append(row)
            log(f"  {label}: {policy.name}/{cfg.name} g={e['g']} -> {sorted(needed)}; err "
                f"{err:.2e}, fault {fault:.2e} (>= {3 * tol:.0e}); {ms:.4f} ms (torch.matmul "
                f"{lib:.4f}, bound {bnd:.4f} by {by})")
            del a, b, operand, bias, copies
        except Exception as ex:
            failures.append(f"{label}: {type(ex).__name__}: {ex}"[:600])
        torch.cuda.empty_cache()
    for name in ("dp_gemm_region", "streamk_phase1"):
        if not launched.get(name):
            failures.append(f"phase 9 (b): {name} never launched")
    if not any(name.startswith("grouped_streamk") for name in launched):
        failures.append("phase 9 (b): B5 never launched")
    seconds = time.perf_counter() - t_phase
    log(f"phase 9 (b): {len(rows)} per-shard GEMMs on the kernels, launches {launched} "
        f"({seconds:.1f}s)")
    return dict(rows=rows, launches=launched, seconds=seconds)




@contextmanager
def own_routing_log(check_router=False):
    """Record, in call order, the top-k indices each MoE layer's own
    ``torch.topk`` returned, whatever its ``moe_impl`` (the sharded one
    routes (G, T/G) token groups: flattened to (T, k)). With
    ``check_router``, each layer's router GEMM is issued once more on the
    active backend and held against ``torch.matmul`` of the layer's input,
    and so is a planted fault of it (the last K chunk dropped)."""
    import torch

    from repro_torch.core.gemm import gemm
    from repro_torch.models import layers

    routes = Routes()
    routes.router_fault = math.inf
    moe_apply = layers.moe_apply

    def recording(p, x, cfg, *, div):
        if check_router:
            xf = x.reshape(-1, x.shape[-1]).float()
            w = p["router"]
            ref = torch.matmul(xf, w.float())
            scale = max(1.0, ref.abs().max().item())
            err = (gemm(xf, w, tag="moe.router").float() - ref).abs().max().item() / scale
            k = xf.shape[1]
            keep = k - 128 if k > 128 else k // 2  # the last K chunk dropped
            bad = gemm(xf[:, :keep].contiguous(), w[:keep].contiguous(), tag="moe.router")
            routes.router_err = max(routes.router_err, err)
            routes.router_fault = min(routes.router_fault,
                                      (bad.float() - ref).abs().max().item() / scale)
        topk = torch.topk

        def spy(probs, k, dim=-1):
            vals, idx = topk(probs, k, dim=dim)
            routes.append(idx.reshape(-1, k))
            return vals, idx

        torch.topk = spy
        try:
            return moe_apply(p, x, cfg, div=div)
        finally:
            torch.topk = topk

    layers.moe_apply = recording
    try:
        yield routes
    finally:
        layers.moe_apply = moe_apply


def moe_variant_run(impl, div, model, params, failures):
    """Phase 9 (c), one variant: olmoe-1b-7b (the caller's full-width bf16
    weights) with ``moe_impl=impl`` served through ``ServeEngine`` on the
    ``cuda`` backend (4 slots, the four seeded prompts x 8 tokens; ``div``
    None: the engine's own, no plan), launch counters zeroed just before and
    read just after; then the four prompts cut to the shortest one's length
    as one (4, S) prefill batch (the sharded variant routes it as 4 token
    groups): its logits against the ``torch`` backend replaying the ``cuda``
    run's top-8 choices (held at olmoe's ``LOGITS_TOL``; each backend routing
    on its own reported), each layer's router GEMM against ``torch.matmul``
    (``ROUTER_TOL``), and a planted fault of each (every fused grouped GEMM,
    and the router, with their last K chunk dropped) at 3x or more."""
    import dataclasses

    import torch

    from repro_torch.core.gemm import gemm_context, get_backend, register_backend
    from repro_torch.kernels.common import LAUNCHES, reset_launch_counts
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    t0 = time.perf_counter()
    arch = "olmoe-1b-7b"
    vmodel = LM(dataclasses.replace(model.cfg, moe_impl=impl))
    cfg = vmodel.cfg
    label = f"{arch} moe_impl={impl}"
    engine = ServeEngine(vmodel, params, ServeConfig(n_slots=N_SLOTS, max_seq=MAX_SEQ, eos=-1),
                         div=div, backend="cuda")
    prompts = serve_prompts(cfg.vocab_size)
    for p in prompts:
        engine.submit(p, max_new_tokens=8)
    reset_launch_counts()
    done = engine.run()
    torch.cuda.synchronize()
    launches = {name: c for name, c in LAUNCHES.items() if c}
    if len(done) != 4 or any(len(r.out_tokens) != 8 or not all(
            0 <= t < cfg.vocab_size for t in r.out_tokens) for r in done):
        raise AssertionError(f"{label}: served {len(done)}/4 requests")
    needed = set()
    for e in engine.selection_log:
        needed |= _kernels_of(e)
    for name in needed:
        if not launches.get(name):
            failures.append(f"{label}: {name} was selected but never launched")
    grouped = b5_called_for(engine, label)  # through the replay accounting (phase 14)
    b5 = sum(c for name, c in launches.items() if name.startswith("grouped_streamk"))
    if b5 != grouped or not grouped:
        failures.append(f"{label}: {b5} B5 launches for {grouped} grouped dispatches (the "
                        f"eager ones once, each captured step's once a replay)")
    expert_m = sorted({e.local_mnk[0] for e in engine.selection_log if e.op.fused})

    s = min(len(p) for p in prompts)
    tokens = torch.as_tensor(np.stack([p[:s] for p in prompts]), device="cuda")
    bdiv = engine.div

    def prefill():
        return vmodel.prefill(params, tokens, div=bdiv)[0]

    with own_routing_log(check_router=True) as routes, gemm_context(backend="cuda"):
        got = prefill()
    with own_routing_log() as routes_torch, gemm_context(backend="torch"):
        want_own = prefill()
    with routing_replay(routes), gemm_context(backend="torch"):
        want = prefill()
    if not torch.isfinite(got).all() or got.shape != (4, 1, cfg.vocab_size):
        raise AssertionError(f"{label}: bad prefill logits {tuple(got.shape)}")
    scale = want.float().abs().max().item()
    replayed = (got.float() - want.float()).abs().max().item()
    own = (got.float() - want_own.float()).abs().max().item()
    flips = routing_flips(routes, routes_torch)

    cuda = get_backend("cuda")

    def drop_last_k_chunk(x, w, *, op, policy, cfg, **kw):
        if op.fused and x.shape[-1] > cfg.bk:
            kk = x.shape[-1] - cfg.bk
            x, w = x[..., :kk].contiguous(), w[:, :kk].contiguous()
        return cuda(x, w, op=op, policy=policy, cfg=cfg, **kw)

    register_backend("cuda_grouped_fault", drop_last_k_chunk, overwrite=True)
    with own_routing_log() as fault_routes, gemm_context(backend="cuda_grouped_fault"):
        bad = prefill()
    with routing_replay(fault_routes), gemm_context(backend="torch"):
        want_f = prefill()
    fault = (bad.float() - want_f.float()).abs().max().item() if torch.isfinite(
        bad).all() else math.inf
    tol = LOGITS_TOL[arch]
    if replayed > tol * scale:
        failures.append(f"{label}: prefill logits with the cuda run's routing replayed: "
                        f"max|diff| {replayed:.4f} > {tol} * {scale:.4f}")
    if routes.router_err > ROUTER_TOL:
        failures.append(f"{label}: router logits vs torch.matmul: {routes.router_err:.3e} > "
                        f"{ROUTER_TOL}")
    if fault < 3 * tol * scale:
        failures.append(f"{label}: the planted fault reads {fault:.4f} < 3 * {tol} * "
                        f"{scale:.4f}")
    if routes.router_fault < 3 * ROUTER_TOL:
        failures.append(f"{label}: the router's planted fault reads {routes.router_fault:.3e} "
                        f"< 3 * {ROUTER_TOL}")
    seconds = time.perf_counter() - t0
    log(f"{label}: served 4/4 with div {engine.div}, launches {launches} ({grouped} grouped "
        f"dispatches at expert M {expert_m}); a (4, {s}) prefill batch vs the torch "
        f"backend replaying the cuda run's top-{cfg.top_k}: max|diff| {replayed:.4f} "
        f"({replayed / scale:.3e} x max|logit|, limit {tol}); each routing alone {own:.4f} "
        f"(flips {flips['assignments']}); router {routes.router_err:.3e} (limit {ROUTER_TOL}); "
        f"planted faults {fault:.4f} (>= {3 * tol * scale:.4f}) and router "
        f"{routes.router_fault:.3e} ({seconds:.1f}s)")
    return dict(impl=impl, div=engine.div, launches=launches, grouped_dispatches=grouped,
                expert_m=expert_m, tokens={r.uid: r.out_tokens for r in done},
                prefill_batch=[4, s], logits_replayed_max_abs_diff=replayed,
                logits_own_routing_max_abs_diff=own, logits_max_abs=scale, logits_tol=tol,
                routing_flips=flips, router_max_rel_err=routes.router_err,
                router_fault=routes.router_fault, planted_fault_max_abs_diff=fault,
                timing=dict(engine.timing), seconds=seconds)


def phase_moe_variants(model, params, failures):
    """Phase 9 (c), run on phase 3's olmoe-1b-7b weights before they are
    freed: each of ``MOE_VARIANTS`` (``moe_variant_run``)."""
    t0 = time.perf_counter()
    out = {impl: moe_variant_run(impl, div, model, params, failures)
           for impl, div in MOE_VARIANTS}
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 9 (c) (olmoe-1b-7b on the sharded and hinted dispatch): {out['seconds']:.1f}s")
    return out


def tokens_agree(a, b):
    """Whether two CLI summaries served the same greedy tokens, worker by
    worker and request by request."""
    return [w["out_tokens"] for w in a["workers"]] == [w["out_tokens"] for w in b["workers"]]


def phase_mesh_model_cli(failures):
    """Phase 9 (d): the serve CLI (``repro_torch.launch.serve.main``) at
    full width, granite-8b, 4 requests x 8 tokens, without a plan and with
    ``--mesh-model 1`` (a (data 1, model 1) plan: every divisor 1), launch
    counters zeroed just before each run and read just after: both exit 0
    with B1 and B2 launched, the plan's divisors logged, and the same greedy
    tokens; a planted fault (one token changed in the second summary) must
    read as a disagreement."""
    import os
    import tempfile

    import torch

    from repro_torch.kernels.common import LAUNCHES, reset_launch_counts
    from repro_torch.launch import serve as cli

    t0 = time.perf_counter()
    base = ["--arch", "granite-8b", "--preset", "full", "--requests", "4", "--slots",
            str(N_SLOTS), "--max-seq", str(MAX_SEQ), "--max-new-tokens", "8"]
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, extra in (("no_plan", []), ("mesh_model_1", ["--mesh-model", "1"])):
            summary = os.path.join(tmp, f"{name}.json")
            reset_launch_counts()
            t1 = time.perf_counter()
            rc = cli.main(base + extra + ["--summary-json", summary])
            torch.cuda.synchronize()
            launches = {n: c for n, c in LAUNCHES.items() if c}
            with open(summary) as f:
                run = json.load(f)
            run.update(rc=rc, launches=launches, seconds=time.perf_counter() - t1)
            runs[name] = run
            gc.collect()
            torch.cuda.empty_cache()
            if rc != 0 or run["completed"] != 4:
                failures.append(f"serve CLI {name}: rc {rc}, {run['completed']}/4 requests")
            for kernel in ("dp_gemm_region", "streamk_phase1"):
                if not launches.get(kernel):
                    failures.append(f"serve CLI {name}: {kernel} never launched")
    plan = runs["mesh_model_1"].get("mesh")
    if plan != {"shape": {"data": 1, "model": 1}, "gemm_div": {"batch": 1, "model": 1}}:
        failures.append(f"serve CLI --mesh-model 1: plan {plan}")
    same = tokens_agree(runs["no_plan"], runs["mesh_model_1"])
    planted = json.loads(json.dumps(runs["mesh_model_1"]))
    planted["workers"][0]["out_tokens"][0][-1] += 1
    fault_seen = not tokens_agree(runs["no_plan"], planted)
    if not same:
        failures.append("serve CLI --mesh-model 1: greedy tokens differ from the run without "
                        "a plan")
    if not fault_seen:
        failures.append("serve CLI --mesh-model 1: the planted token went unseen")
    seconds = time.perf_counter() - t0
    log(f"phase 9 (d) serve CLI granite-8b: plan {plan}; tokens equal without and with the "
        f"plan: {same}; planted fault seen: {fault_seen}; launches "
        f"{runs['mesh_model_1']['launches']} ({seconds:.1f}s)")
    return dict(runs={k: {key: v[key] for key in ("rc", "completed", "launches", "seconds",
                                                   "mesh") if key in v}
                      for k, v in runs.items()},
                tokens=[w["out_tokens"] for w in runs["mesh_model_1"]["workers"]],
                same_tokens=same, fault_seen=fault_seen, seconds=seconds)


def phase_shard(dry, moe_variants, gen, failures):
    """Phase 9: (a) the dry run's cells, (b) the per-shard GEMMs on the
    kernels, (c) the MoE variants' record (run inside phase 3), (d) the
    serve CLI's ``--mesh-model``. Returns the phase's record."""
    import torch

    t0 = time.perf_counter()
    dryrun = phase_dryrun(*dry, failures)
    gemms = phase_shard_gemms(dryrun["artifacts"], gen, failures) if dryrun else None
    gc.collect()
    torch.cuda.empty_cache()
    cli = phase_mesh_model_cli(failures)
    seconds = time.perf_counter() - t0 + moe_variants["seconds"]
    log(f"phase 9 (plans, dry run, per-shard GEMMs, MoE variants, --mesh-model): "
        f"{seconds:.1f}s ((c) {moe_variants['seconds']:.1f}s of it inside phase 3)")
    if dryrun:
        dryrun.pop("artifacts")
    return dict(dryrun=dryrun, shard_gemms=gemms, moe_variants=moe_variants, mesh_model_cli=cli,
                seconds=seconds)


class Routes(list):
    """Each MoE layer's top-k expert choice ((T, k) indices) in call order,
    and ``router_err``: the largest max|diff| of a layer's router logits
    against ``torch.matmul`` of the same input, over max(1, max|ref|)
    (``own_routing_log`` adds ``router_fault``: the least such reading of
    the router GEMM with its last K chunk dropped)."""

    router_err = 0.0


@contextmanager
def routing_log(check_router=False):
    """Record each MoE layer's top-k expert choice ((T, k) indices) while the
    block runs, under whatever backend is active. The router GEMM is issued
    once more for the record; nothing else changes. With ``check_router``,
    the router logits are also held against ``torch.matmul`` of the layer's
    own input (``Routes.router_err``)."""
    import torch

    from repro_torch.core.gemm import gemm
    from repro_torch.models import layers

    routes = Routes()
    moe_apply = layers.moe_apply

    def recording(p, x, cfg, *, div):
        xf = x.reshape(-1, x.shape[-1]).float()
        logits = gemm(xf, p["router"], tag="moe.router")
        if check_router:
            ref = torch.matmul(xf, p["router"].float())
            err = (logits.float() - ref).abs().max().item() / max(1.0, ref.abs().max().item())
            routes.router_err = max(routes.router_err, err)
        routes.append(torch.topk(torch.softmax(logits, -1), cfg.top_k, dim=-1).indices)
        return moe_apply(p, x, cfg, div=div)

    layers.moe_apply = recording
    try:
        yield routes
    finally:
        layers.moe_apply = moe_apply


@contextmanager
def routing_replay(routes):
    """Make each MoE layer take, in call order, the top-k experts of
    ``routes`` (one (T, k) index tensor per layer, as ``routing_log``
    records them) in place of its own choice; the gates are the layer's own
    probabilities at those experts."""
    import torch

    from repro_torch.models import layers

    moe_apply = layers.moe_apply
    queue = iter(routes)

    def replaying(p, x, cfg, *, div):
        idx = next(queue)
        topk = torch.topk

        def take(probs, k, dim=-1):
            # (T, k) recorded; a layer routing (G, T/G) token groups asks per group
            i = idx.reshape(*probs.shape[:-1], idx.shape[-1])
            return probs.gather(dim, i), i

        torch.topk = take
        try:
            return moe_apply(p, x, cfg, div=div)
        finally:
            torch.topk = topk

    layers.moe_apply = replaying
    try:
        yield
    finally:
        layers.moe_apply = moe_apply


def routing_flips(routes_a, routes_b):
    """How two runs' routing differs: the (layer, token, rank) assignments
    that name another expert, and the (layer, token) pairs whose expert set
    differs (a swap of two ranks changes the first count, not the second)."""
    import torch

    assignments, tokens, where = 0, 0, []
    for layer, (ra, rb) in enumerate(zip(routes_a, routes_b)):
        ne = (ra != rb).nonzero().tolist()
        assignments += len(ne)
        where += [(layer, t, r) for t, r in ne][:8]
        tokens += int((torch.sort(ra, -1).values != torch.sort(rb, -1).values).any(-1).sum())
    return dict(layers=len(routes_a), assignments=assignments, token_sets=tokens,
                first=where[:8])


def planted_fault_diff(model, params, selector, prompt, want, *, grouped, rung=None,
                       replay=False, b1=False, prefill=None, layers=False):
    """max|logit diff| against ``want`` of a prefill whose GEMMs of one kind
    drop their last K chunk (``cfg.bk`` of K): the DP-policy GEMMs (the
    reading a B1 that skips one chunk of its K loop would give), with ``b1``
    every GEMM whose partition has a DP region (a hybrid pick runs B1 there:
    the models whose prefill picks no pure DP), or, with ``grouped``, every
    fused grouped GEMM (a B5 that does the same); on a quantized ``rung``,
    every DP-policy and grouped GEMM of the rung. A non-finite prefill reads
    as infinitely far. Returns that and, with ``replay``, the same prefill
    against the ``torch`` backend replaying its top-k choices (else None).
    ``prefill``, when given, is the prefill to run (it returns the logits),
    in place of ``model.prefill`` of ``prompt``. With ``layers``, the second
    value is the fault run's largest layer-replayed reading
    (``layer_replayed_diff``), over the scale of each reading."""
    import torch

    from repro_torch.core.gemm import gemm_context, get_backend, register_backend
    from repro_torch.core.policies import DP
    from repro_torch.core.workpart import GemmShape, partition

    cuda = get_backend("cuda")

    def drop_last_k_chunk(x, w, *, op, policy, cfg, **kw):
        if rung is not None:
            hit = RUNG_OF.get(op.in_dtype) == rung and (op.fused or policy == DP)
        elif grouped:
            hit = op.fused
        elif b1:
            shape = GemmShape(x.shape[1], w.shape[-1], x.shape[-1])
            hit = not op.fused and partition(shape, cfg, kw["g"], policy).dp_tiles > 0
        else:
            hit = policy == DP
        if hit and x.shape[-1] > cfg.bk:
            kk = x.shape[-1] - cfg.bk  # a multiple of bk: even, so packed int4 rows are kk / 2
            kw_rows = kk // 2 if kw.get("b_bits") == 4 else kk
            x, w = x[..., :kk].contiguous(), w[:, :kw_rows].contiguous()
        return cuda(x, w, op=op, policy=policy, cfg=cfg, **kw)

    register_backend("cuda_planted_fault", drop_last_k_chunk, overwrite=True)
    tokens = None if prompt is None else torch.as_tensor(prompt, device="cuda")[None]
    if prefill is None:
        prefill = lambda: model.prefill(params, tokens)[0]  # noqa: E731
    with routing_log() as routes, layer_trace(layers) as trace, \
            gemm_context(selector=selector, backend="cuda_planted_fault"):
        bad = prefill()
    if not torch.isfinite(bad).all():
        return math.inf, math.inf if replay or layers else None
    replayed = None
    if layers:
        replayed = max(layer_replayed_diff(prefill, trace, bad))
    if replay:
        with routing_replay(routes), gemm_context(backend="torch"):
            want_r, _ = model.prefill(params, tokens)
        replayed = (bad.float() - want_r.float()).abs().max().item()
    return (bad.float() - want.float()).abs().max().item(), replayed


#: name fragments of the hand-written kernels in profiler traces
GEMM_KERNELS = ("dp_fma_kernel", "dp_mma_kernel", "dp_s8_kernel", "streamk_kernel",
                "grouped_sk_kernel", "grouped_dp_kernel")


def decode_breakdown(step, iters=5):
    """Where a warm decode step's time goes: wall time (host clock ending in
    a synchronise), the host's enqueue time (until ``step`` returns), and,
    from one ``torch.profiler`` trace, the device's busy time, the share of
    it in the GEMM kernels, the device ms of any kernel named a fix-up (B3
    is fused into B2: none should run), and the busiest kernels by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    enqueue = wall = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        step()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enqueue += t1 - t0
        wall += time.perf_counter() - t0
    wall_ms, enqueue_ms = wall / iters * 1e3, enqueue / iters * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    by_name = device_ms_by_name(prof)
    busy = sum(by_name.values())
    gemm = sum(v for name, v in by_name.items() if any(f in name for f in GEMM_KERNELS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(
        step_ms=wall_ms, enqueue_ms=enqueue_ms,
        # None when the trace holds no device events ("not measured")
        device_busy_ms=busy or None, gemm_kernels_ms=gemm if busy else None,
        idle_share=1.0 - busy / wall_ms if busy else None,
        fixup_ms=sum(v for name, v in by_name.items() if "fixup" in name),
        top_kernels=[[name[:90], ms] for name, ms in top],
    )


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# Phase 10: across ranks
# ---------------------------------------------------------------------------

#: two ranks, processes that share the one card over gloo (NCCL refuses two
#: ranks on one device): they prove the kernels at shard shapes with real
#: exchanges between ranks, and nothing of NVLink
MR_RANKS = 2
#: phase 10 (c): granite-8b at full width cut to 1 layer, 2 rows of 1024
#: tokens, 1 step on (2, 1) then 1 on (1, 2) from the checkpoint (cut from 2
#: layers and 2 + 2 steps to make room for phase 11 in the time limit)
MR_TRAIN_LAYERS, MR_TRAIN_ROWS, MR_TRAIN_SEQ, MR_TRAIN_STEPS = 1, 2, 1024, 1
MR_GROUP_TIMEOUT_S = 600
MR_CLI_TIMEOUT_S, MR_RANKS_TIMEOUT_S = 300, 900
BLOOM_KEYS = 2**20
#: copies of each winner's (M, N, K) among phase 10 (d)'s keys
BLOOM_COPIES = 4
#: the card's compute mode (phase 1): a second process opens a CUDA context
#: only in the Default mode
CARD = {}


def _torchrun(args, timeout):
    """``python -m torch.distributed.run --standalone --nproc-per-node 2``
    with ``args``, in a process group of its own that is killed whole at the
    timeout: (exit code or "timeout", seconds, stdout, stderr)."""
    return _torchrun_all([args], timeout)[0]


def _torchrun_start(args, stdout=subprocess.PIPE, stderr=subprocess.PIPE):
    """Start ``python -m torch.distributed.run --standalone --nproc-per-node 2``
    with ``args`` in a process group of its own (the launcher picks its own
    free port)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                                if p]))
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         str(MR_RANKS), *args], env=env, cwd=ROOT, stdout=stdout, stderr=stderr, text=True,
        start_new_session=True)


def _torchrun_wait(proc, deadline):
    """Wait for a :func:`_torchrun_start` launcher until ``deadline``
    (``time.perf_counter``), its whole process group killed past it: (exit
    code or "timeout", stdout, stderr)."""
    import signal

    try:
        stdout, stderr = proc.communicate(timeout=max(1.0, deadline - time.perf_counter()))
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
        rc = "timeout"
    return rc, stdout, stderr


def _torchrun_all(arg_lists, timeout):
    """:func:`_torchrun` of each of ``arg_lists``, all started together and
    waited for in turn, every one under the same deadline."""
    t0 = time.perf_counter()
    procs = [_torchrun_start(args) for args in arg_lists]
    out = []
    for proc in procs:
        rc, stdout, stderr = _torchrun_wait(proc, t0 + timeout)
        out.append((rc, time.perf_counter() - t0, stdout, stderr))
    return out


def start_background_ranks():
    """The rank parts that need nothing from this process (``chip_smoke.py
    --background-ranks DIR``, ``background_ranks_main``: phase 10 (c), then phase 11's,
    12's and 13's), started on two ranks of their own before phase 5: they run beside
    phases 5-9, which leave most of the card and the host's cores free (phase 10 (c) is
    mostly checkpoint I/O and gloo traffic through host memory; at most about 22 GB on the
    card, beside phase 6's 44). Its output goes to a file
    in its directory (a pipe nobody reads would stall it). Returns the job: its launcher,
    its directory, its start."""
    import tempfile

    tmp = tempfile.mkdtemp(dir=ROOT, prefix=".multirank_bg_")
    with open(os.path.join(tmp, "log.txt"), "w") as f:
        proc = _torchrun_start([str(ROOT / "chip_smoke.py"), "--background-ranks", tmp],
                               stdout=f, stderr=subprocess.STDOUT)
    return dict(proc=proc, dir=tmp, t0=time.perf_counter())


def finish_background_ranks(job):
    """Wait for :func:`start_background_ranks`' job (``MR_RANKS_TIMEOUT_S`` from its
    start) and remove its directory: (exit code or "timeout", seconds, each rank's output
    or None, the end of its log)."""
    import shutil

    import torch

    rc, _, _ = _torchrun_wait(job["proc"], job["t0"] + MR_RANKS_TIMEOUT_S)
    seconds = time.perf_counter() - job["t0"]
    paths = [os.path.join(job["dir"], f"bg{r}.pt") for r in range(MR_RANKS)]
    outs = [torch.load(p) if os.path.exists(p) else None for p in paths]
    with open(os.path.join(job["dir"], "log.txt")) as f:
        tail = f.read()[-4000:]
    shutil.rmtree(job["dir"], ignore_errors=True)
    return rc, seconds, outs, tail


@contextmanager
def planted_zero_all_reduce(rank, call, every=0):
    """Rank 1 contributes zeros to the ``call``-th all-reduce of the block
    (the exchange still happens, so the ranks stay in step): the rank's
    partial sum never arrives. With ``every``, also to each ``every``-th
    all-reduce after it (the same exchange in every later layer)."""
    from repro_torch.dist import collectives

    raw = collectives.raw_all_reduce
    seen = [0]

    def faulty(x, ax, op="sum"):
        n = seen[0]
        seen[0] += 1
        if rank == 1 and (n == call or (every and n > call and (n - call) % every == 0)):
            x = x.detach() * 0
        return raw(x, ax, op=op)

    collectives.raw_all_reduce = faulty
    try:
        yield
    finally:
        collectives.raw_all_reduce = raw


def _mr_launches():
    from repro_torch.kernels.common import LAUNCHES

    return {name: c for name, c in LAUNCHES.items() if c}


def _mr_tokens(vocab, device):
    import torch

    prompts = serve_prompts(vocab)
    s = min(len(p) for p in prompts)
    return torch.as_tensor(np.stack([p[:s] for p in prompts]), device=device)


def mr_granite(rank, w1_prefix=None):
    """Phase 10 (a) on each rank: granite-8b at full width and depth on
    (1, 2): a (4, S) prefill and one greedy decode step through the kernels,
    the gathered logits; then the prefill again with rank 1's partial of
    layer 0's attn.o all-reduce zeroed (the planted fault). With
    ``w1_prefix`` (W1: a served request's tokens up to the first position
    where the CLI on two ranks and on one rank chose differently), also that
    prefix's last-position logits."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.gemm import gemm_context
    from repro_torch.dist.sharding import ShardingPlan, use_plan
    from repro_torch.kernels.common import reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM

    from repro_torch.serve.graphs import step_mode

    model = LM(get_config("granite-8b"))
    plan = ShardingPlan(make_host_mesh(model=MR_RANKS))
    tokens = _mr_tokens(model.cfg.vocab_size, "cuda")
    s = tokens.shape[1]
    pos = torch.full((tokens.shape[0],), s, device="cuda")
    with use_plan(plan), torch.no_grad():
        params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
        reset_launch_counts()
        with gemm_context(backend="cuda") as ctx:
            logits, cache = model.prefill(params, tokens, max_seq=s + 1)
            nxt = logits[:, -1].argmax(-1)[:, None]
            step, _ = model.decode_step(params, cache, nxt, pos)
        torch.cuda.synchronize()
        launches = _mr_launches()
        with gemm_context(backend="cuda"):
            split = mr_decode_split(rank, lambda: model.decode_step(params, cache, nxt, pos))
        del cache
        with planted_zero_all_reduce(rank, call=1), gemm_context(backend="cuda"):
            bad, _ = model.prefill(params, tokens, max_seq=s + 1)
        w1 = None
        if w1_prefix is not None:
            with gemm_context(backend="cuda"):
                w1, _ = model.prefill(params, w1_prefix.cuda()[None])
            w1 = w1[0, -1].float().cpu()
        mode = step_mode("cuda")  # phase 14 (f): under the plan
    keys = sorted({f"{e.tag}:{e.local_mnk}" for e in ctx.log})
    del params
    return dict(prefill=logits.cpu(), decode=step.cpu(), next=nxt.cpu(), fault=bad.cpu(),
                launches=launches, keys=keys, layers=model.cfg.n_layers, split=split, w1=w1,
                step_mode=mode)


def mr_decode_split(rank, step, iters=5):
    """Where a warm decode step's time goes on this rank across the ranks:
    the wall ms a step (host clock ending in a synchronise), the ms a step
    inside the collectives (each timed from a synchronised device, so the
    exchange alone over ``gloo``), and, on rank 0 alone, the device busy ms
    of one ``torch.profiler`` trace (its own process's kernels; the ranks
    share the card). The other rank runs the same step untraced."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.dist.collectives import record

    step()
    torch.cuda.synchronize()
    with record() as coll:
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / iters * 1e3
    busy = None
    if rank == 0:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        busy = sum(device_ms_by_name(prof).values()) or None  # None: "not measured"
    else:
        step()
        torch.cuda.synchronize()
    coll_ms = coll.seconds / iters * 1e3
    return dict(step_ms=wall_ms, collective_ms=coll_ms,
                collectives_a_step=coll.total_count // iters, device_busy_ms=busy,
                rest_ms=None if busy is None else wall_ms - coll_ms - busy)


def mr_olmoe(rank):
    """Phase 10 (b) on each rank: olmoe-1b-7b at full width and depth on
    (1, 2) with ``moe_impl="shard_map"``: a (4, S) prefill through the
    kernels (B5 at G = 32), each layer's top-8 choices and router check;
    then the prefill with rank 1's partial of layer 0's MoE combine zeroed."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.gemm import gemm_context
    from repro_torch.dist.sharding import ShardingPlan, use_plan
    from repro_torch.kernels.common import reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM

    model = LM(dataclasses.replace(get_config("olmoe-1b-7b"), moe_impl="shard_map"))
    plan = ShardingPlan(make_host_mesh(model=MR_RANKS))
    tokens = _mr_tokens(model.cfg.vocab_size, "cuda")
    with use_plan(plan), torch.no_grad():
        params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
        reset_launch_counts()
        with gemm_context(backend="cuda") as ctx, own_routing_log(check_router=True) as routes:
            logits, _ = model.prefill(params, tokens)
        torch.cuda.synchronize()
        launches = _mr_launches()
        # call 0 is the embedding's all-reduce, 1 layer 0's attn.o, 2 its MoE combine
        with planted_zero_all_reduce(rank, call=2), own_routing_log() as fault_routes, \
                gemm_context(backend="cuda"):
            bad, _ = model.prefill(params, tokens)
    groups = sorted({e.op.g_local for e in ctx.log if e.op.fused})
    del params
    return dict(logits=logits.cpu(), routes=[r.cpu() for r in routes],
                router_err=routes.router_err, router_fault=routes.router_fault,
                fault=bad.cpu(), fault_routes=[r.cpu() for r in fault_routes],
                launches=launches, groups=groups)


def _mr_train_parts():
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.lm import LM
    from repro_torch.optim import constant, make_optimizer

    cfg = dataclasses.replace(get_config("granite-8b"), n_layers=MR_TRAIN_LAYERS)
    return (LM(cfg), make_optimizer("adamw", constant(1e-4)),
            SyntheticLMData(cfg, batch=MR_TRAIN_ROWS, seq_len=MR_TRAIN_SEQ, seed=1))


def mr_train(rank, workdir):
    """Phase 10 (c) on each rank: granite-8b at full width, ``MR_TRAIN_LAYERS``
    layers. Rank 0 first runs the one-rank reference on the ``torch`` backend
    (the first step's gradients, ``Trainer.fit`` for 2 x ``MR_TRAIN_STEPS``
    steps); then on (2, 1) and on (1, 2) each rank takes the first step's
    gradients (summed, gathered whole on every rank), and ``Trainer.fit``
    runs ``MR_TRAIN_STEPS`` on (2, 1), checkpoints, and resumes for as many
    on (1, 2). Rank 0 holds the readings."""
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch.core.gemm import gemm_context
    from repro_torch.dist.collectives import sync_grads
    from repro_torch.dist.sharding import ShardingPlan, gather_tree, local_rows, use_plan
    from repro_torch.kernels.common import reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import Trainer, TrainerConfig, init_train_state
    from repro_torch.train.trainer import take_grads, to_device_batch
    from repro_torch.utils.trees import tree_items

    def params_for(model):
        params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
        for _, leaf in tree_items(params):
            leaf.requires_grad_(True)
        return params

    out = {}
    ref_grads = None
    if rank == 0:
        model, opt, data = _mr_train_parts()
        with gemm_context(backend="torch"):
            params = params_for(model)
            loss, _ = model.loss_fn(params, to_device_batch(data.batch_at(0), "cuda"))
            loss.backward()
            ref_grads = dict(tree_items(take_grads(params)))
            out["ref_first_loss"] = loss.item()
            del params, loss
            t = Trainer(model, opt, data, TrainerConfig(total_steps=2 * MR_TRAIN_STEPS,
                                                        log_every=100))
            t.fit(init_train_state(model, opt, params_for(model)))
            out["ref_history"] = list(t.history)
            del t
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    ckpt = os.path.join(workdir, "ckpt")
    for mesh, total in (((2, 1), MR_TRAIN_STEPS), ((1, 2), 2 * MR_TRAIN_STEPS)):
        name = f"{mesh[0]}x{mesh[1]}"
        model, opt, data = _mr_train_parts()
        plan = ShardingPlan(make_host_mesh(model=mesh[1]))
        with use_plan(plan), gemm_context(backend="cuda"):
            params = params_for(model)
            batch = local_rows(to_device_batch(data.batch_at(0), "cuda"))
            loss, _ = model.loss_fn(params, batch)
            loss.backward()
            grads = sync_grads(take_grads(params), model.param_specs(), plan)
            full = dict(tree_items(gather_tree(grads, plan, model.param_specs())))
            del grads, params
            if ref_grads is not None:
                out[f"grad_{name}"] = _grad_diff(full, ref_grads)
                # the planted fault: every gathered leaf one row off
                shifted = {k: torch.roll(v, 1, 0) for k, v in full.items()}
                out[f"grad_fault_{name}"] = _grad_diff(shifted, ref_grads)[0]
                # and the loss of this rank's rows alone (its share never summed)
                out[f"loss_share_{name}"] = loss.item()
            del full, loss
            t = Trainer(model, opt, data, TrainerConfig(total_steps=total, log_every=100,
                                                        ckpt_dir=ckpt, ckpt_every=100))
            reset_launch_counts()
            t.fit(init_train_state(model, opt, params_for(model)))
            torch.cuda.synchronize()
            out[f"launches_{name}"] = _mr_launches()
            out[f"history_{name}"] = list(t.history)
            del t
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        shutil.rmtree(ckpt, ignore_errors=True)
    return out


def _rank_setup():
    """A rank's start (under ``torch.distributed.run``): its gloo group, its device, the
    kernels the parent built loaded (never built). Returns the rank."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.kernels import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=MR_GROUP_TIMEOUT_S))
    rank = dist.get_rank()
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    cuda_lib.library(build=False)
    return rank


def multirank_main(workdir) -> int:
    """One rank of phase 10's rank program (started by ``torch.distributed.run``
    from ``phase_multirank``): (a) and (b) in turn on the ranks; each rank writes
    what it saw to ``<workdir>/rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    rank = _rank_setup()
    out = {}
    t0 = time.perf_counter()
    w1 = os.path.join(workdir, "w1.pt")
    out["granite"] = mr_granite(rank, torch.load(w1) if os.path.exists(w1) else None)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out["olmoe"] = mr_olmoe(rank)
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = dict(granite=t1 - t0, olmoe=time.perf_counter() - t1)
    log(f"phase 10 rank {rank}: {out['part_seconds']}")
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def background_ranks_main(workdir) -> int:
    """One rank of the rank parts started ahead (:func:`start_background_ranks`):
    phase 10 (c), then phase 11's, 12's and 13's rank parts, in one process group; each
    rank writes what it saw to ``<workdir>/bg<r>.pt`` (once before phase 13's parts, so
    the earlier phases keep theirs whatever befalls those)."""
    import torch
    import torch.distributed as dist

    rank = _rank_setup()
    t0 = time.perf_counter()
    out = {"train": mr_train(rank, workdir)}
    out["part_seconds"] = dict(train=time.perf_counter() - t0)
    log(f"phase 10 (c) rank {rank}: {out['part_seconds']['train']:.1f}s")
    # phase 11's rank parts
    t0 = time.perf_counter()
    for name, part in (("quant", mr11_quant), ("olmoe", mr11_olmoe), ("data", mr11_data),
                       ("paged", mr11_paged)):
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        out[f"serve11_{name}"] = part(rank)
        out["part_seconds"][f"serve11_{name}"] = time.perf_counter() - t1
    out["serve11_seconds"] = time.perf_counter() - t0
    # phase 12's rank parts, in the same process group
    t0 = time.perf_counter()
    for arch, layers in MR12_CELLS:
        gc.collect()
        torch.cuda.empty_cache()
        out[f"fam12_{arch}"] = mr12_family(rank, arch, layers)
    out["fam12_seconds"] = time.perf_counter() - t0
    # what the earlier phases need is kept before phase 13's parts run
    torch.save(out, os.path.join(workdir, f"bg{rank}.pt"))
    t0 = time.perf_counter()
    for name, part in (("mr13_decode", mr13_decode), ("mr13_long", mr13_long),
                       ("mr13_train", mr13_train)):
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        out[name] = part(rank)
        out["part_seconds"][name] = time.perf_counter() - t1
    out["prod13_seconds"] = time.perf_counter() - t0
    torch.save(out, os.path.join(workdir, f"bg{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _read(rel, limit, what, failures):
    """Record a failure when ``rel`` exceeds ``limit`` (or is not finite)."""
    if not rel <= limit:
        failures.append(f"{what}: {rel:.4g} > {limit}")
    return rel


def _planted(reading, limit, what, failures):
    if not reading >= 3 * limit:
        failures.append(f"{what}: the planted fault reads {reading:.4g} < 3 x {limit}")
    return reading


def phase_multirank_cli(run, cli_tokens, failures):
    """Phase 10 (a), first half: the serve CLI under ``torch.distributed.run``
    on 2 ranks (``--mesh-model 2``; run by ``rank_clis``), granite-8b at full
    width and depth, 4 requests x 8 tokens: exit 0, 4/4 requests, B1 and B2
    launched on each rank, a decode step's collectives equal to the dry run's
    for the same cell (a planted extra all-reduce must read as a
    disagreement), the greedy tokens beside phase 9 (d)'s one-rank run."""
    from repro_torch.launch import dryrun

    rc, seconds, err, summary = run
    if rc != 0 or summary is None:
        failures.append(f"phase 10 (a) serve CLI on {MR_RANKS} ranks: exit {rc}; stderr "
                        f"{err[-3000:]}")
        log(f"phase 10 (a) serve CLI: exit {rc}\n{err[-3000:]}")
        return dict(rc=rc, seconds=seconds)
    if summary["completed"] != 4:
        failures.append(f"phase 10 (a) serve CLI: {summary['completed']}/4 requests")
    for r, launches in enumerate(summary["launches_by_rank"]):
        for kernel in ("dp_gemm_region", "streamk_phase1"):
            if not launches.get(kernel):
                failures.append(f"phase 10 (a) serve CLI: {kernel} never launched on rank {r}")
    art = dryrun.lower_cell("granite-8b", "decode_32k", False, mesh_shape=(1, MR_RANKS),
                            shape_overrides={"global_batch": N_SLOTS, "seq_len": MAX_SEQ})
    coll = summary["collectives"]
    same = coll["per_decode_step"] == art["collectives"] and not coll["uneven_ops"]
    planted = json.loads(json.dumps(art["collectives"]))
    planted["all-reduce"]["count"] += 1
    fault_seen = coll["per_decode_step"] != planted
    if not same:
        failures.append(f"phase 10 (a): a decode step's collectives {coll['per_decode_step']} "
                        f"(uneven {coll['uneven_ops']}) vs the dry run's {art['collectives']}")
    if not fault_seen:
        failures.append("phase 10 (a): the planted extra all-reduce went unseen")
    tokens = summary["workers"][0]["out_tokens"]
    agree = None if cli_tokens is None else sum(
        a == b for ra, rb in zip(tokens, cli_tokens[0]) for a, b in zip(ra, rb))
    log(f"phase 10 (a) serve CLI on {MR_RANKS} ranks: exit {rc}, {summary['completed']}/4, "
        f"launches by rank {summary['launches_by_rank']}; a decode step's collectives "
        f"{coll['per_decode_step']} == the dry run's: {same} (planted fault seen: "
        f"{fault_seen}); decode {coll['decode_ms']:.1f} ms over {coll['decode_steps']} steps, "
        f"{coll['collective_ms']:.1f} ms of it in collectives; greedy tokens equal to phase "
        f"9 (d)'s one-rank run: {agree}/32 ({seconds:.1f}s)")
    return dict(rc=rc, seconds=seconds, completed=summary["completed"],
                launches_by_rank=summary["launches_by_rank"], collectives=coll,
                dryrun_collectives=art["collectives"], same_collectives=same,
                fault_seen=fault_seen, tokens=tokens, tokens_agree_with_phase9=agree,
                mesh=summary["mesh"], prompts=summary["workers"][0]["prompts"])


def phase_multirank_ranks(failures, bg_job, w1=None):
    """Phase 10 (a) second half, (b) and (c): the rank program
    (``multirank_main``) and ``bg_job``'s outputs ((c), phases 11's and 12's
    rank parts), then this process's one-rank references on the same
    weights; with ``w1`` (``w1_prefix``), W1's readings at the first
    position where the CLI's greedy tokens on two ranks and on one differ.
    Returns (the phase's record, each rank's output of both programs)."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.gemm import gemm_context
    from repro_torch.dist.sharding import ShardingPlan, use_plan
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM

    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".multirank_") as tmp:
        if w1 is not None:
            torch.save(w1["prefix"], os.path.join(tmp, "w1.pt"))
        rc, seconds, out, err = _torchrun([str(ROOT / "chip_smoke.py"), "--multirank", tmp],
                                          MR_RANKS_TIMEOUT_S)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) if os.path.exists(
            os.path.join(tmp, f"rank{r}.pt")) else None for r in range(MR_RANKS)]
    bg_rc, bg_seconds, bgs, bg_log = finish_background_ranks(bg_job)
    if bg_rc != 0 or None in bgs:
        failures.append(f"phases 10 (c), 11 and 12 on {MR_RANKS} ranks: exit {bg_rc}; log "
                        f"{bg_log[-3000:]}")
        log(f"phases 10 (c), 11 and 12 on the ranks: exit {bg_rc}\n{bg_log}")
    if rc != 0 or None in ranks:
        failures.append(f"phase 10 rank program on {MR_RANKS} ranks: exit {rc}; stderr "
                        f"{err[-3000:]}")
        log(f"phase 10 rank program: exit {rc}\n{out[-2000:]}\n{err[-4000:]}")
        return dict(rc=rc, seconds=seconds), None
    rec = dict(rc=rc, seconds=seconds, rank_seconds=[r["seconds"] for r in ranks],
               part_seconds=[r["part_seconds"] for r in ranks], background_rc=bg_rc,
               background_seconds=bg_seconds,
               background_part_seconds=[None if b is None else b["part_seconds"] for b in bgs],
               step_modes=[r["granite"]["step_mode"] for r in ranks])

    # (a) granite-8b: the one-rank torch backend on the same weights and tokens
    g = ranks[0]["granite"]
    model = LM(get_config("granite-8b"))
    tokens = _mr_tokens(model.cfg.vocab_size, "cuda")
    s = tokens.shape[1]
    with torch.no_grad(), gemm_context(backend="torch"):
        params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
        want, cache = model.prefill(params, tokens, max_seq=s + 1)
        want_step, _ = model.decode_step(params, cache, g["next"].cuda(),
                                         torch.full((tokens.shape[0],), s, device="cuda"))
        if w1 is not None and g["w1"] is not None:
            rec["w1"] = w1_readings(model, params, w1, [r["granite"]["w1"] for r in ranks])
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    tol = LOGITS_TOL["granite-8b"]
    readings = {}
    for key, ref in (("prefill", want), ("decode", want_step)):
        ref = ref.float().cpu()
        scale = ref.abs().max().item()
        readings[key] = _read((g[key].float() - ref).abs().max().item() / scale, tol,
                              f"phase 10 (a) granite-8b {key} logits on (1, 2) vs one rank",
                              failures)
    ref = want.float().cpu()
    fault = _planted((g["fault"].float() - ref).abs().max().item() / ref.abs().max().item(),
                     tol, "phase 10 (a) rank 1's attn.o partial dropped", failures)
    same_ranks = all(torch.equal(r["granite"]["prefill"], g["prefill"]) for r in ranks)
    if not same_ranks:
        failures.append("phase 10 (a): the ranks' gathered logits differ")
    for r, out_r in enumerate(ranks):
        for kernel in ("dp_gemm_region", "streamk_phase1"):
            if not out_r["granite"]["launches"].get(kernel):
                failures.append(f"phase 10 (a) rank program: {kernel} never launched on "
                                f"rank {r}")
    rec["granite"] = dict(layers=g["layers"], logits_rel=readings, fault_rel=fault, tol=tol,
                          launches=[r["granite"]["launches"] for r in ranks], keys=g["keys"],
                          decode_split=[r["granite"]["split"] for r in ranks])
    log(f"phase 10 (a) granite-8b ({g['layers']} layers) on (1, 2): gathered logits vs the "
        f"one-rank torch backend, max|diff| / max|logit|: prefill {readings['prefill']:.3e}, "
        f"decode {readings['decode']:.3e} (limit {tol}); planted fault {fault:.3e}; launches "
        f"{rec['granite']['launches']}; a warm decode step by rank (wall / collectives, the "
        f"exchange alone / device busy / the rest, ms): {rec['granite']['decode_split']}")

    # (b) olmoe-1b-7b on shard_map: the one-rank body replaying the ranks' routing
    o = ranks[0]["olmoe"]
    model = LM(dataclasses.replace(get_config("olmoe-1b-7b"), moe_impl="shard_map"))
    tokens = _mr_tokens(model.cfg.vocab_size, "cuda")
    with torch.no_grad(), gemm_context(backend="torch"), \
            use_plan(ShardingPlan(make_host_mesh(1))):
        params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
        with routing_replay([r.cuda() for r in o["routes"]]):
            want, _ = model.prefill(params, tokens)
        with routing_replay([r.cuda() for r in o["fault_routes"]]):
            want_f, _ = model.prefill(params, tokens)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    tol = LOGITS_TOL["olmoe-1b-7b"]
    want, want_f = want.float().cpu(), want_f.float().cpu()
    rel = _read((o["logits"].float() - want).abs().max().item() / want.abs().max().item(), tol,
                "phase 10 (b) olmoe-1b-7b logits on (1, 2), routing replayed", failures)
    fault = _planted((o["fault"].float() - want_f).abs().max().item() / want_f.abs().max().item(),
                     tol, "phase 10 (b) rank 1's MoE combine partial dropped", failures)
    router = max(r["olmoe"]["router_err"] for r in ranks)
    _read(router, ROUTER_TOL, "phase 10 (b) router logits vs torch.matmul", failures)
    router_fault = _planted(min(r["olmoe"]["router_fault"] for r in ranks), ROUTER_TOL,
                            "phase 10 (b) router with its last K chunk dropped", failures)
    for r, out_r in enumerate(ranks):
        b5 = sum(c for k, c in out_r["olmoe"]["launches"].items()
                 if k.startswith("grouped_streamk"))
        if out_r["olmoe"]["groups"] != [32] or not b5:
            failures.append(f"phase 10 (b) rank {r}: grouped dispatches at G "
                            f"{out_r['olmoe']['groups']}, {b5} B5 launches (want G = 32)")
    rec["olmoe"] = dict(logits_rel=rel, fault_rel=fault, tol=tol, router_err=router,
                        router_fault=router_fault, groups=o["groups"],
                        launches=[r["olmoe"]["launches"] for r in ranks])
    log(f"phase 10 (b) olmoe-1b-7b shard_map on (1, 2): logits vs the one-rank body replaying "
        f"the ranks' top-8, max|diff| / max|logit| {rel:.3e} (limit {tol}); planted fault "
        f"{fault:.3e}; router {router:.3e} (limit {ROUTER_TOL}, planted {router_fault:.3e}); B5 "
        f"at G {o['groups']}, launches {rec['olmoe']['launches']}")

    # (c) training: rank 0's readings against its one-rank reference
    if None in bgs:
        return rec, None
    for r, b in zip(ranks, bgs):  # phases 11's and 12's rank parts join (a)'s and (b)'s
        r.update({key: v for key, v in b.items() if key != "part_seconds"})
    t = ranks[0]["train"]
    ref = t["ref_history"]
    k = MR_TRAIN_STEPS
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(t["history_2x1"] + t["history_1x2"],
                                                        ref[:k] + ref[k:]))
    _read(loss_rel, TRAIN_LOSS_TOL, "phase 10 (c) losses on (2, 1) -> (1, 2) vs one rank",
          failures)
    loss_fault = _planted(abs(t["loss_share_2x1"] - t["ref_first_loss"]) / abs(
        t["ref_first_loss"]), TRAIN_LOSS_TOL, "phase 10 (c) one rank's loss share alone",
        failures)
    grads = {}
    for name in ("2x1", "1x2"):
        grads[name] = _read(t[f"grad_{name}"][0], TRAIN_GRAD_TOL,
                            f"phase 10 (c) first-step gradients on {name} vs one rank", failures)
        _planted(t[f"grad_fault_{name}"], TRAIN_GRAD_TOL,
                 f"phase 10 (c) gradients one row off on {name}", failures)
    for r, out_r in enumerate(ranks):
        for name in ("2x1", "1x2"):
            if not out_r["train"][f"launches_{name}"].get("dp_gemm_region") and not out_r[
                    "train"][f"launches_{name}"].get("streamk_phase1"):
                failures.append(f"phase 10 (c) rank {r}: no GEMM kernel launched on {name}")
    rec["train"] = dict(history={"2x1": t["history_2x1"], "1x2": t["history_1x2"]},
                        reference=ref, loss_rel=loss_rel, loss_fault=loss_fault,
                        grads_rel=grads, grads_worst={n: t[f"grad_{n}"][1] for n in grads},
                        grads_fault={n: t[f"grad_fault_{n}"] for n in grads},
                        launches=[{n: r["train"][f"launches_{n}"] for n in grads}
                                  for r in ranks])
    log(f"phase 10 (c) granite-8b ({MR_TRAIN_LAYERS} layers, {MR_TRAIN_ROWS} x {MR_TRAIN_SEQ}) "
        f"{k} steps on (2, 1), checkpoint, {k} on (1, 2): losses {t['history_2x1']} + "
        f"{t['history_1x2']} vs one rank {ref}, max rel {loss_rel:.3e} (limit "
        f"{TRAIN_LOSS_TOL}, planted {loss_fault:.3e}); first-step gradients rel L2 {grads} "
        f"(limit {TRAIN_GRAD_TOL}, planted {rec['train']['grads_fault']})")
    return rec, ranks


def w1_prefix(cli, cli_tokens):
    """W1: the first (request, position) where the serve CLI's greedy tokens
    on two ranks (phase 10 (a)) and on one (phase 9 (d)) differ, and the
    request's tokens before it (its prompt and the tokens both chose); None
    when they agree everywhere."""
    import torch

    if cli_tokens is None or "tokens" not in cli:
        return None
    for r, (two, one) in enumerate(zip(cli["tokens"], cli_tokens[0])):
        for i, (a, b) in enumerate(zip(two, one)):
            if a != b:
                return dict(request=r, position=i, two_rank=a, one_rank=b,
                            prefix=torch.as_tensor(cli["prompts"][r] + two[:i]))
    return None


def w1_readings(model, params, w1, two_rank_logits):
    """W1's readings at its prefix (the caller's granite-8b weights at full
    depth): the one-rank ``cuda`` logits' top-2 margin over max|logit|,
    beside the two-rank ``cuda`` logits against them and against the
    one-rank ``torch`` backend's. A margin within the two-rank reading makes
    the differing token a near-tie flip."""
    import torch

    from repro_torch.core.gemm import gemm_context

    pre = w1["prefix"].cuda()[None]
    with gemm_context(backend="cuda"):
        one, _ = model.prefill(params, pre)
    with gemm_context(backend="torch"):
        ref, _ = model.prefill(params, pre)
    one, ref = one[0, -1].float().cpu(), ref[0, -1].float().cpu()
    two = two_rank_logits[0]
    scale = one.abs().max().item()
    top = torch.topk(one, 2)
    margin = (top.values[0] - top.values[1]).item() / scale
    two_top = torch.topk(two, 2)
    out = dict(request=w1["request"], position=w1["position"],
               tokens={"two_rank": w1["two_rank"], "one_rank": w1["one_rank"]},
               one_rank_top2=top.indices.tolist(), two_rank_top2=two_top.indices.tolist(),
               margin=margin,
               two_rank_margin=(two_top.values[0] - two_top.values[1]).item() / scale,
               two_vs_one_cuda=(two - one).abs().max().item() / scale,
               two_vs_one_torch=(two - ref).abs().max().item() / ref.abs().max().item(),
               one_cuda_vs_torch=(one - ref).abs().max().item() / ref.abs().max().item(),
               ranks_agree=all(torch.equal(t, two) for t in two_rank_logits))
    out["near_tie"] = margin <= out["two_vs_one_cuda"]
    log(f"W1: request {out['request']} position {out['position']}: two ranks chose "
        f"{w1['two_rank']}, one rank {w1['one_rank']}; one-rank cuda top-2 {out['one_rank_top2']} "
        f"margin {margin:.3e} x max|logit|, two-rank top-2 {out['two_rank_top2']} margin "
        f"{out['two_rank_margin']:.3e}; two-rank cuda vs one-rank cuda "
        f"{out['two_vs_one_cuda']:.3e}, "
        f"vs one-rank torch {out['two_vs_one_torch']:.3e} (one-rank cuda vs torch "
        f"{out['one_cuda_vs_torch']:.3e}); near-tie flip: {out['near_tie']}")
    return out


@contextmanager
def planted_probe_offset():
    """Every probe of ``device_bloom``'s query one bit past its position (the
    planted fault of phase 10 (d))."""
    import torch

    from repro_torch.core import device_bloom

    probe = device_bloom._probe
    device_bloom._probe = lambda h1, h2, i, n_bits: torch.remainder(
        probe(h1, h2, i, n_bits) + 1, n_bits)
    try:
        yield
    finally:
        device_bloom._probe = probe


def phase_bloom(sieve, winners, failures):
    """Phase 10 (d): ``device_bloom`` on 2**20 keys against filters of phase
    4's sieve geometry that hold phase 4's winners keyed on their bare
    (M, N, K), the key ``BloomFilter.query_mnk`` and the batched query read
    (phase 4's own sieve keys on the extended op key, which no bare-size
    query finds). The keys: each winner's (M, N, K) ``BLOOM_COPIES`` times,
    the rest random sizes, shuffled. On the card, bit for bit against the
    same query on the CPU and, on 4096 random keys and every winner's,
    against ``BloomFilter.query_mnk``; every winner present in its
    policies' filters; its ms. Planted faults: every probe one bit off must
    change the answer for most winners' keys; a key with one bit flipped
    must move exactly its own hash."""
    import torch

    from repro_torch.core import device_bloom
    from repro_torch.core.opensieve import OpenSieve

    owners = {}
    for key, pol in winners.items():
        owners.setdefault(tuple(int(v) for v in key[:3]), set()).add(pol.name)
    bare = OpenSieve(sieve.policies, capacity=sieve.capacity, fp_rate=sieve.fp_rate)
    policies = {p.name: p for p in sieve.policies}
    for mnk, names in owners.items():
        for name in names:
            bare.insert_winner(mnk, policies[name])
    names = list(bare.filters)
    filters = [bare.filters[name] for name in names]
    sizes = sorted(owners)
    rng = np.random.default_rng(10)
    keys = rng.integers(1, 2**16, (BLOOM_KEYS, 3))
    where = rng.choice(BLOOM_KEYS, len(sizes) * BLOOM_COPIES, replace=False)
    keys[where] = np.repeat(np.array(sizes, dtype=np.int64), BLOOM_COPIES, axis=0)
    keys = keys.T
    dev = [torch.as_tensor(k, device="cuda") for k in keys]
    got = device_bloom.query_filters(filters, *dev)
    torch.cuda.synchronize()
    found = got.cpu()
    cpu = device_bloom.query_filters(filters, *(torch.as_tensor(k) for k in keys))
    same = torch.equal(found, cpu)
    sample = np.union1d(rng.choice(BLOOM_KEYS, 4096, replace=False), where)
    py = torch.tensor([[f.query_mnk(*(int(keys[d, i]) for d in range(3))) for f in filters]
                       for i in sample])
    same_py = torch.equal(found[sample], py)
    want = torch.tensor([[name in owners[size] for name in names]
                         for size in sizes]).repeat_interleave(BLOOM_COPIES, dim=0)
    missed = int((want & ~found[where]).sum())
    present = found.float().mean().item()
    ms, event_ms = time_ms(lambda: device_bloom.query_filters(filters, *dev), iters=10)
    with planted_probe_offset():
        bad = device_bloom.query_filters(filters, *dev).cpu()
    turned = (bad[where] != found[where]).any(dim=-1).float().mean().item()
    words = device_bloom.mnk_to_words(*dev)
    h = device_bloom.murmur3_32_words(words, filters[0].seed)
    flipped, j = words.clone(), BLOOM_KEYS // 3
    flipped[j, 2] ^= 1 << 7
    moved = (device_bloom.murmur3_32_words(flipped, filters[0].seed) != h).nonzero().flatten()
    fault_seen = moved.tolist() == [j] and turned >= 0.5
    if not (same and same_py):
        failures.append(f"phase 10 (d) device_bloom: card vs CPU equal {same}, vs "
                        f"BloomFilter.query_mnk equal {same_py}")
    if missed or not present > 0:
        failures.append(f"phase 10 (d) device_bloom: {missed} winners' answers absent from "
                        f"their policies' filters, 'possibly present' share {present}")
    if not fault_seen:
        failures.append(f"phase 10 (d) device_bloom: probes one bit off changed "
                        f"{turned:.4f} of the winners' answers (want >= 0.5); the flipped key "
                        f"moved hashes {moved[:8]}")
    log(f"phase 10 (d) device_bloom: {BLOOM_KEYS} keys ({len(sizes)} winners' sizes x "
        f"{BLOOM_COPIES} among them) x {len(filters)} filters on the card: bit for bit the "
        f"CPU's ({same}) and, on {len(sample)} keys, BloomFilter.query_mnk's ({same_py}); "
        f"winners missed {missed}; {ms:.3f} ms (event {event_ms:.3f} ms); 'possibly present' "
        f"share {present:.6f}; probes one bit off changed {turned:.4f} of the winners' "
        f"answers; a flipped key bit moved only its hash: {moved.tolist() == [j]}")
    return dict(keys=BLOOM_KEYS, filters=len(filters), winners=len(sizes),
                copies=BLOOM_COPIES, equal_cpu=same, equal_python=same_py, missed=missed,
                ms=ms, event_ms=event_ms, present_share=present, fault_turned=turned,
                fault_seen=fault_seen)


def multirank_launches(rec):
    """Phase 10's launches by run, each a list of the ranks' counters."""
    out = {}
    if rec["cli"].get("launches_by_rank"):
        out["serve_cli"] = rec["cli"]["launches_by_rank"]
    for run in ("granite", "olmoe"):
        if run in rec["ranks"]:
            out[run] = rec["ranks"][run]["launches"]
    if "train" in rec["ranks"]:
        for name in ("2x1", "1x2"):
            out[f"train_{name}"] = [r[name] for r in rec["ranks"]["train"]["launches"]]
    return out


def phase_multirank(cli_run, cli_tokens, sieve, winners, bg_job, failures):
    """Phase 10: serve and train across ranks (two processes on the one card
    over gloo; (c) and phases 11's and 12's rank parts ran in ``bg_job``,
    :func:`start_background_ranks`') and the batched Bloom query."""
    import torch

    t0 = time.perf_counter()
    if CARD.get("compute_mode") not in (None, "Default"):
        failures.append(f"phase 10: compute mode {CARD['compute_mode']}: a second process "
                        "cannot open a CUDA context")
    gc.collect()
    torch.cuda.empty_cache()
    cli = phase_multirank_cli(cli_run, cli_tokens, failures)
    w1 = w1_prefix(cli, cli_tokens)
    ranks, rank_outs = phase_multirank_ranks(failures, bg_job, w1)
    if w1 is not None and "w1" not in ranks:
        failures.append("W1: the first differing position was not read")
    gc.collect()
    torch.cuda.empty_cache()
    bloom = phase_bloom(sieve, winners, failures) if sieve is not None else None
    if sieve is None:
        failures.append("phase 10 (d): phase 4 left no sieve")
    seconds = time.perf_counter() - t0
    log(f"phase 10 (across ranks, gloo through host memory, two processes on one card: "
        f"nothing here measures NVLink): {seconds:.1f}s")
    return dict(cli=cli, ranks=ranks, bloom=bloom, seconds=seconds,
                compute_mode=CARD.get("compute_mode"), rank_outs=rank_outs)


# ---------------------------------------------------------------------------
# Phase 11: serving across ranks as the serve CLI runs under a plan
# ---------------------------------------------------------------------------

#: phase 11's depth cuts, at full width: granite-8b at 4 of 36 layers for the
#: drivers of (a) and (d), at 2 on (2, 1) in (c) (every decode step there
#: all-gathers every FSDP weight over gloo through host memory); both cut in
#: PR 32 (from 8 and 4) to make room for phase 12 in the time limit; (a)'s
#: serve CLI runs and olmoe-1b-7b in (b) at full depth
MR11_LAYERS, MR11_DATA_LAYERS = 4, 2
MR11_RUNGS = ("int8-dynamic", "int4")
#: tokens a request in (c)'s and (d)'s engines and (a)'s CLI runs
MR11_NEW = 4
#: the paged pool's page size (phase 5's)
MR11_PAGE = 16


def _granite_at(layers):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM

    return LM(dataclasses.replace(get_config("granite-8b"), n_layers=layers))


@contextmanager
def zeroed_max_all_reduce():
    """The planted fault of a row-parallel int8-dynamic dispatch: every MAX
    all-reduce's result zeroed, so each row's scale falls to its floor and
    every code saturates. (Each rank's own half-row amax is no fault to
    plant: the rank dequantizes its partial with its own scale, so the sum
    differs from ``repro``'s codes by quantization noise only.)"""
    from repro_torch.dist import collectives

    raw = collectives.raw_all_reduce

    def faulty(x, ax, op="sum"):
        out = raw(x, ax, op=op)
        return out * 0 if op == "max" else out

    collectives.raw_all_reduce = faulty
    try:
        yield
    finally:
        collectives.raw_all_reduce = raw


@contextmanager
def local_weight_amax():
    """The planted fault of quantizing shards: each column's scale over this
    rank's part of K (the MAX all-reduce of the amaxes skipped)."""
    from repro_torch.core import quant

    real = quant._all_reduce_max
    quant._all_reduce_max = lambda x, axes: x
    try:
        yield
    finally:
        quant._all_reduce_max = real


def quant_digest(params):
    """path -> sha256 of a quantized leaf's values and scales bytes."""
    import hashlib

    from repro_torch.core.quant import is_quantized

    out = {}

    def walk(t, prefix):
        for key, leaf in t.items():
            if isinstance(leaf, dict):
                walk(leaf, f"{prefix}{key}/")
            elif is_quantized(leaf):
                h = hashlib.sha256(leaf.values.cpu().numpy().tobytes())
                h.update(leaf.scales.cpu().numpy().tobytes())
                out[prefix + key] = h.hexdigest()

    walk(params, "")
    return out


@contextmanager
def decode_logits_log(model):
    """Record every ``model.decode_step``'s input tokens and logits (as the
    caller's engine issues them) while the block runs."""
    steps = []
    real = model.decode_step

    def recording(params, cache, tokens, cur_pos, *, div=None):
        logits, cache = real(params, cache, tokens, cur_pos, div=div)
        steps.append((tokens.cpu(), logits.float().cpu()))
        return logits, cache

    model.decode_step = recording
    try:
        yield steps
    finally:
        del model.decode_step


@contextmanager
def sampled_log(engine, forced=None):
    """Record every token ``engine`` samples, in order; with ``forced`` (a
    list), hand out those tokens in its place (teacher forcing: another run's
    choices, so both runs take the same inputs)."""
    seen = []
    real = engine._sample
    queue = iter(forced) if forced is not None else None

    def sample(logits, temperature):
        tok = real(logits, temperature) if queue is None else next(queue)
        seen.append(tok)
        return tok

    engine._sample = sample
    try:
        yield seen
    finally:
        del engine._sample


def _decode_keys(log_entries):
    return sorted({f"{e.tag}:{e.local_mnk}" for e in log_entries})


def mr11_quant(rank):
    """Phase 11 (a) on each rank: granite-8b cut to ``MR11_LAYERS`` on (1, 2),
    quantized on each of ``MR11_RUNGS`` (the shards quantized together: the
    column amaxes all-reduced with MAX where K splits): the codes' digests,
    a (4, S) prefill and a greedy decode step through the rung's kernels
    (launches counted), the step's collectives and a warm step's split; the
    planted fault: int8-dynamic's MAX all-reduce of the row amaxes zeroed,
    int4's column scales over the rank's half of K."""
    import torch

    from repro_torch.core.gemm import gemm_context
    from repro_torch.dist.collectives import record
    from repro_torch.dist.sharding import ShardingPlan, use_plan
    from repro_torch.kernels.common import reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh

    model = _granite_at(MR11_LAYERS)
    plan = ShardingPlan(make_host_mesh(model=MR_RANKS))
    tokens = _mr_tokens(model.cfg.vocab_size, "cuda")
    s = tokens.shape[1]
    pos = torch.full((tokens.shape[0],), s, device="cuda")
    out = {}
    with use_plan(plan), torch.no_grad():
        base = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
        for rung in MR11_RUNGS:
            bits, act_bits, _ = RUNGS[rung]
            params, _, _ = model.quantize_weights(base, bits=bits, act_bits=act_bits)
            digest = quant_digest(params)
            reset_launch_counts()
            with gemm_context(backend="cuda") as ctx:
                logits, cache = model.prefill(params, tokens, max_seq=s + 1)
                nxt = logits[:, -1].argmax(-1)[:, None]
                n0 = len(ctx.log)
                with record() as coll:
                    step, _ = model.decode_step(params, cache, nxt, pos)
                keys = _decode_keys(ctx.log[n0:])
            torch.cuda.synchronize()
            launches = _mr_launches()
            with gemm_context(backend="cuda"):
                split = mr_decode_split(rank, lambda: model.decode_step(params, cache, nxt, pos))
            del cache
            fault_digest = None
            if act_bits:
                with zeroed_max_all_reduce(), gemm_context(backend="cuda"):
                    bad, _ = model.prefill(params, tokens, max_seq=s + 1)
            else:
                with local_weight_amax():
                    bad_params, _, _ = model.quantize_weights(base, bits=bits, act_bits=act_bits)
                fault_digest = quant_digest(bad_params)
                with gemm_context(backend="cuda"):
                    bad, _ = model.prefill(bad_params, tokens, max_seq=s + 1)
                del bad_params
            out[rung] = dict(prefill=logits.cpu(), decode=step.cpu(), next=nxt.cpu(),
                             fault=bad.cpu(), digest=digest, fault_digest=fault_digest,
                             launches=launches, record=coll.summary(), keys=keys, split=split)
            del params
            gc.collect()
            torch.cuda.empty_cache()
    return out


def mr11_olmoe(rank):
    """Phase 11 (b) on each rank: olmoe-1b-7b at full width and depth on
    (1, 2) on its default ``moe_impl`` (``global``: every rank routes the
    whole batch with the f32 router, dispatches to its 32 experts, B5 at
    G = 32), dense and ``int8``: a (4, S) prefill's logits, each layer's
    top-8 choices and router check, and the first served prompt's prefill
    logits; the (4, S) prefill with rank 1's partial of every layer's MoE
    combine zeroed; a warm decode step's split (dense)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.gemm import gemm_context
    from repro_torch.dist.sharding import ShardingPlan, use_plan
    from repro_torch.kernels.common import reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM

    model = LM(get_config("olmoe-1b-7b"))
    plan = ShardingPlan(make_host_mesh(model=MR_RANKS))
    tokens = _mr_tokens(model.cfg.vocab_size, "cuda")
    first_prompt = torch.as_tensor(serve_prompts(model.cfg.vocab_size)[0], device="cuda")[None]
    s = tokens.shape[1]
    out = {"moe_impl": model.cfg.moe_impl}
    with use_plan(plan), torch.no_grad():
        base = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
        for rung in ("dense", "int8"):
            params = base if rung == "dense" else model.quantize_weights(base, bits=8)[0]
            reset_launch_counts()
            with gemm_context(backend="cuda") as ctx, \
                    own_routing_log(check_router=True) as routes:
                logits, cache = model.prefill(params, tokens, max_seq=s + 1)
            torch.cuda.synchronize()
            launches = _mr_launches()
            # the first prompt alone: the input phase 3 holds a rung's limit on
            with gemm_context(backend="cuda"):
                first, _ = model.prefill(params, first_prompt)
            # call 0 is the embedding's all-reduce, then each layer's attn.o and MoE
            # combine: every layer's combine from 2 on
            with planted_zero_all_reduce(rank, call=2, every=2), \
                    own_routing_log() as fault_routes, gemm_context(backend="cuda"):
                bad, _ = model.prefill(params, tokens)
            split = None
            if rung == "dense":
                nxt = logits[:, -1].argmax(-1)[:, None]
                pos = torch.full((tokens.shape[0],), s, device="cuda")
                with gemm_context(backend="cuda"):
                    split = mr_decode_split(rank, lambda: model.decode_step(params, cache, nxt,
                                                                            pos))
            del cache
            out[rung] = dict(logits=logits.cpu(), first=first.cpu(),
                             routes=[r.cpu() for r in routes],
                             router_err=routes.router_err, router_fault=routes.router_fault,
                             fault=bad.cpu(), fault_routes=[r.cpu() for r in fault_routes],
                             launches=launches, split=split,
                             groups=sorted({e.op.g_local for e in ctx.log if e.op.fused}))
            del params
            gc.collect()
            torch.cuda.empty_cache()
    return out


def mr11_data(rank):
    """Phase 11 (c) on each rank: granite-8b cut to ``MR11_DATA_LAYERS`` on
    (2, 1), dense: a (4, S) prefill and a decode step (2 rows a rank, the
    weights all-gathered over data), the decode keys and a warm step's
    split; then the slot engine at 4 slots (2 a rank) over the four prompts,
    its tokens and a decode step's collectives."""
    import torch

    from repro_torch.core.gemm import gemm_context
    from repro_torch.dist.sharding import ShardingPlan, use_plan
    from repro_torch.kernels.common import reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import decode_collectives
    from repro_torch.serve import ServeConfig, ServeEngine

    model = _granite_at(MR11_DATA_LAYERS)
    plan = ShardingPlan(make_host_mesh(model=1))
    tokens = _mr_tokens(model.cfg.vocab_size, "cuda")
    s = tokens.shape[1]
    pos = torch.full((tokens.shape[0],), s, device="cuda")
    with use_plan(plan), torch.no_grad():
        params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
        reset_launch_counts()
        with gemm_context(backend="cuda") as ctx:
            logits, cache = model.prefill(params, tokens, max_seq=s + 1)
            nxt = logits[:, -1].argmax(-1)[:, None]
            n0 = len(ctx.log)
            step, _ = model.decode_step(params, cache, nxt, pos)
        keys = _decode_keys(ctx.log[n0:])
        with gemm_context(backend="cuda"):
            split = mr_decode_split(rank, lambda: model.decode_step(params, cache, nxt, pos),
                                    iters=2)
        cache_rows = int(cache["attn"]["k"].shape[1])
        del cache
        engine = ServeEngine(model, params, ServeConfig(n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                                        eos=-1), backend="cuda")
        for p in serve_prompts(model.cfg.vocab_size):
            engine.submit(p, max_new_tokens=MR11_NEW)
        with sampled_log(engine) as sampled:
            done = sorted(engine.run(), key=lambda r: r.uid)
        torch.cuda.synchronize()
        launches = _mr_launches()
        own = engine.own_slots
        mode = engine.step_mode  # phase 14 (f): under the plan
    return dict(prefill=logits.cpu(), decode=step.cpu(), next=nxt.cpu(), keys=keys, split=split,
                cache_rows=cache_rows, tokens=[r.out_tokens for r in done], sampled=sampled,
                own_slots=None if own is None else [own.start, own.stop],
                collectives=decode_collectives(engine), launches=launches, step_mode=mode)


def mr11_paged(rank):
    """Phase 11 (d) on each rank: granite-8b cut to ``MR11_LAYERS`` on
    (1, 2) through the paged engine (this rank's kv heads in the pool) over
    the four prompts: its tokens, every decode step's logits, and the
    device ms of the gather of a full 4 x ``MAX_SEQ`` view of the pool."""
    import torch

    from repro_torch.dist.sharding import ShardingPlan, use_plan
    from repro_torch.kernels.common import reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import PagedServeConfig, PagedServeEngine

    model = _granite_at(MR11_LAYERS)
    plan = ShardingPlan(make_host_mesh(model=MR_RANKS))
    with use_plan(plan), torch.no_grad():
        params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
        engine = PagedServeEngine(model, params, PagedServeConfig(
            page_size=MR11_PAGE, max_pages=N_SLOTS * MAX_SEQ // MR11_PAGE, max_active=N_SLOTS,
            max_seq=MAX_SEQ, eos=-1), backend="cuda")
        for p in serve_prompts(model.cfg.vocab_size):
            engine.submit(p, max_new_tokens=MR11_NEW)
        reset_launch_counts()
        with decode_logits_log(model) as steps, sampled_log(engine) as sampled:
            done = sorted(engine.run(), key=lambda r: r.uid)
        torch.cuda.synchronize()
        launches = _mr_launches()
        pool = engine.kv.pool
        pages = torch.arange(N_SLOTS * MAX_SEQ // MR11_PAGE).reshape(N_SLOTS, -1)
        # one rank at a time: the ranks share the card
        for r in range(MR_RANKS):
            torch.distributed.barrier()
            if r == rank:
                gather_ms, _ = time_ms(lambda: engine.kv.gather_view(pool, pages), iters=10)
        view_bytes = sum(a.numel() * a.element_size() for a in pool["attn"].values()) * (
            pages.numel() / pool["attn"]["k"].shape[1])
        mode = engine.step_mode  # phase 14 (f): under the plan
    return dict(step_mode=mode, tokens=[r.out_tokens for r in done], steps=steps, sampled=sampled,
                kv_heads=int(pool["attn"]["k"].shape[-2]), gather_ms=gather_ms,
                gather_bytes=view_bytes, launches=launches, metrics=engine.metrics())


def _rel(got, want):
    want = want.float().cpu()
    return (got.float().cpu() - want).abs().max().item() / want.abs().max().item()


def _rung_launched(launches, rung):
    return {k: launches.get(f"{k}[{rung}]", 0) for k in ("dp_gemm_region", "streamk_phase1")}


def rank_clis(keys):
    """The serve CLIs ``keys`` names under ``torch.distributed.run``, started together (two
    processes on the card each, each pair its own group), each on (1, 2) at full width and
    depth, 4 requests: ``"granite-8b"`` dense, 8 tokens a request (phase 10 (a)); each of
    ``MR11_RUNGS``, granite-8b with ``--quantize`` on it (phase 11 (a)); ``"mamba2-1.3b"``
    (phase 12 (a)); ``MR11_NEW`` tokens a request for these. Returns each run's (exit code
    or "timeout", seconds, stderr, summary or None) by key."""
    import tempfile

    base = ["-m", "repro_torch.launch.serve", "--preset", "full", "--requests", "4",
            "--slots", str(N_SLOTS), "--max-seq", str(MAX_SEQ), "--mesh-model", str(MR_RANKS)]
    new = ["--max-new-tokens", str(MR11_NEW)]
    args = {"granite-8b": ["--arch", "granite-8b", "--max-new-tokens", "8"]}
    args.update({rung: ["--arch", "granite-8b", "--quantize", rung] + new
                 for rung in MR11_RUNGS})
    args["mamba2-1.3b"] = ["--arch", "mamba2-1.3b"] + new
    args = {key: args[key] for key in keys}
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        paths = {key: os.path.join(tmp, f"{key}.json") for key in args}
        runs = _torchrun_all([base + a + ["--summary-json", paths[key]]
                              for key, a in args.items()], MR_CLI_TIMEOUT_S)
        return {key: (rc, seconds, err, json.load(open(paths[key]))
                      if os.path.exists(paths[key]) else None)
                for key, (rc, seconds, _, err) in zip(args, runs)}


def phase11_cli(runs, failures):
    """Phase 11 (a), the serve CLI (``rank_clis``): granite-8b at full width and depth on
    (1, 2) with ``--quantize`` on each of ``MR11_RUNGS``, 4 requests: exit 0,
    4/4, each rank's B1 and B2 launches on the rung, a decode step's
    collectives: the float dry run's (1, 2) decode cell, plus, on
    int8-dynamic, one MAX all-reduce of the slots' (4, 1) f32 row amax per
    row-parallel dispatch (attn.o and mlp.out of every layer)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    layers = get_config("granite-8b").n_layers
    art = dryrun.lower_cell("granite-8b", "decode_32k", False, mesh_shape=(1, MR_RANKS),
                            shape_overrides={"global_batch": N_SLOTS, "seq_len": MAX_SEQ})
    out = {}
    for rung in MR11_RUNGS:
        rc, seconds, err, summary = runs[rung]
        what = f"phase 11 (a) serve CLI --quantize {rung} on (1, {MR_RANKS})"
        if rc != 0 or summary is None:
            failures.append(f"{what}: exit {rc}; stderr {err[-3000:]}")
            log(f"{what}: exit {rc}\n{err[-3000:]}")
            out[rung] = dict(rc=rc, seconds=seconds)
            continue
        if summary["completed"] != 4 or summary.get("quantize") != rung:
            failures.append(f"{what}: {summary['completed']}/4 requests on rung "
                            f"{summary.get('quantize')}")
        launched = [_rung_launched(by, rung) for by in summary["launches_by_rank"]]
        for r, by in enumerate(launched):
            for kernel, n in by.items():
                if not n:
                    failures.append(f"{what}: {kernel}[{rung}] never launched on rank {r}")
        want = json.loads(json.dumps(art["collectives"]))
        if rung == "int8-dynamic":
            want["all-reduce"]["count"] += 2 * layers
            want["all-reduce"]["bytes"] += 2 * layers * N_SLOTS * 4
        coll = summary["collectives"]
        same = coll["per_decode_step"] == want and not coll["uneven_ops"]
        planted = json.loads(json.dumps(want))
        planted["all-reduce"]["count"] -= 1  # one row-parallel MAX all-reduce left out
        if not same:
            failures.append(f"{what}: a decode step's collectives {coll['per_decode_step']} "
                            f"(uneven {coll['uneven_ops']}) vs {want}")
        if coll["per_decode_step"] == planted:
            failures.append(f"{what}: the planted missing all-reduce went unseen")
        steps = max(coll["decode_steps"], 1)
        log(f"{what}: exit {rc}, {summary['completed']}/4, mesh {summary['mesh']['shape']}; "
            f"B1/B2 launches on the rung by rank {launched}; a decode step's collectives "
            f"{coll['per_decode_step']} == the float dry run's + the rung's: {same}; decode "
            f"{coll['decode_ms'] / steps:.2f} ms a step, {coll['collective_ms'] / steps:.2f} of "
            f"it in collectives ({seconds:.1f}s)")
        out[rung] = dict(rc=rc, seconds=seconds, completed=summary["completed"],
                         launches_by_rank=summary["launches_by_rank"], collectives=coll,
                         want_collectives=want, same_collectives=same,
                         tokens=summary["workers"][0]["out_tokens"])
    return out


def phase11_quant(outs, failures):
    """Phase 11 (a), the driver's readings against this process's one-rank
    references on the same weights: each rank's codes and scales equal to
    the one-rank quantization of the whole leaves cut to its shard (the
    digests), the gathered logits against the ``torch`` backend on the same
    quantized weights at ``QUANT_LOGITS_TOL``, the planted fault 3x or
    caught (int4: the digests differ), B1 and B2 launched on the rung."""
    import torch

    from repro_torch.core.gemm import gemm_context
    from repro_torch.dist.sharding import ShardingPlan, shard_tree
    from repro_torch.launch.mesh import virtual_mesh

    model = _granite_at(MR11_LAYERS)
    tokens = _mr_tokens(model.cfg.vocab_size, "cuda")
    s = tokens.shape[1]
    pos = torch.full((tokens.shape[0],), s, device="cuda")
    rec = {}
    with torch.no_grad():
        base = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
        for rung in MR11_RUNGS:
            bits, act_bits, _ = RUNGS[rung]
            params, _, _ = model.quantize_weights(base, bits=bits, act_bits=act_bits)
            want_digest = []
            for r in range(MR_RANKS):
                plan = ShardingPlan(virtual_mesh((1, MR_RANKS), coords={"data": 0, "model": r}))
                want_digest.append(quant_digest(shard_tree(params, plan, plan.mesh.coords,
                                                           model.param_specs())))
            g = outs[0][rung]
            with gemm_context(backend="torch"):
                want, cache = model.prefill(params, tokens, max_seq=s + 1)
                want_step, _ = model.decode_step(params, cache, g["next"].cuda(), pos)
            del params, cache
            tol = QUANT_LOGITS_TOL[("granite-8b", rung)]
            what = f"phase 11 (a) granite-8b x {MR11_LAYERS} {rung} on (1, {MR_RANKS})"
            digests = [o[rung]["digest"] == want_digest[r] for r, o in enumerate(outs)]
            if not all(digests):
                failures.append(f"{what}: a rank's codes or scales differ from the one-rank "
                                f"quantization cut to its shard: {digests}")
            readings = {key: _read(_rel(g[key], ref), tol, f"{what} {key} logits", failures)
                        for key, ref in (("prefill", want), ("decode", want_step))}
            fault = _rel(g["fault"], want)
            caught = None
            if g["fault_digest"] is not None:
                caught = g["fault_digest"] != want_digest[0]
            if not (fault >= 3 * tol or caught):
                failures.append(f"{what}: the planted fault reads {fault:.4g} < 3 x {tol} and "
                                "is not caught")
            if not all(torch.equal(o[rung]["prefill"], g["prefill"]) for o in outs):
                failures.append(f"{what}: the ranks' gathered logits differ")
            launched = [_rung_launched(o[rung]["launches"], rung) for o in outs]
            for r, by in enumerate(launched):
                if not all(by.values()):
                    failures.append(f"{what}: rank {r} launched {by}")
            rec[rung] = dict(logits_rel=readings, tol=tol, fault_rel=fault, fault_caught=caught,
                             digests_equal=digests, launches=[o[rung]["launches"] for o in outs],
                             record=g["record"], keys=g["keys"],
                             decode_split=[o[rung]["split"] for o in outs])
            log(f"{what}: codes and scales equal to the one-rank quantization's shards: "
                f"{digests}; gathered logits vs the one-rank torch backend on the same weights, "
                f"max|diff| / max|logit|: prefill {readings['prefill']:.3e}, decode "
                f"{readings['decode']:.3e} (limit {tol}); planted fault {fault:.3e} (codes "
                f"differ: {caught}); launches by rank {rec[rung]['launches']}; a decode step's "
                f"collectives {g['record']}; a warm step by rank {rec[rung]['decode_split']}")
            gc.collect()
            torch.cuda.empty_cache()
    del base
    return rec


def phase11_olmoe(outs, failures):
    """Phase 11 (b): olmoe-1b-7b's readings against this process's one-rank
    ``torch`` backend on the same weights: dense with the ranks' top-8
    choices replayed at ``LOGITS_TOL`` on the (4, S) batch, int8 on its own
    routing at ``QUANT_LOGITS_TOL`` as phase 3 holds a rung (the first
    served prompt's prefill; the batch's own-routing reading and the
    replayed one reported), the router at ``ROUTER_TOL``, the routing flips,
    the planted fault 3x, B5 at G = 32 on each rank."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.gemm import gemm_context
    from repro_torch.models.lm import LM

    model = LM(get_config("olmoe-1b-7b"))
    tokens = _mr_tokens(model.cfg.vocab_size, "cuda")
    first_prompt = torch.as_tensor(serve_prompts(model.cfg.vocab_size)[0], device="cuda")[None]
    o = outs[0]
    rec = {"moe_impl": o["moe_impl"]}
    if o["moe_impl"] != "global":
        failures.append(f"phase 11 (b): olmoe-1b-7b served on {o['moe_impl']}, not its default")
    with torch.no_grad():
        base = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
        for rung in ("dense", "int8"):
            params = base if rung == "dense" else model.quantize_weights(base, bits=8)[0]
            g = o[rung]
            with gemm_context(backend="torch"):
                with routing_replay([r.cuda() for r in g["routes"]]):
                    replayed, _ = model.prefill(params, tokens)
                with routing_replay([r.cuda() for r in g["fault_routes"]]):
                    replayed_f, _ = model.prefill(params, tokens)
                with own_routing_log() as own_routes:
                    own, _ = model.prefill(params, tokens)
                first, _ = model.prefill(params, first_prompt)
            del params
            what = f"phase 11 (b) olmoe-1b-7b global {rung} on (1, {MR_RANKS})"
            own_rel = _rel(g["logits"], own)
            if rung == "dense":
                tol = LOGITS_TOL["olmoe-1b-7b"]
                rel = _read(_rel(g["logits"], replayed), tol, f"{what}, routing replayed",
                            failures)
                first_rel = _rel(g["first"], first)
            else:
                tol = QUANT_LOGITS_TOL[("olmoe-1b-7b", "int8")]
                rel = _rel(g["logits"], replayed)
                first_rel = _read(_rel(g["first"], first), tol,
                                  f"{what}, the first prompt on its own routing", failures)
            fault = _planted(_rel(g["fault"], replayed_f), tol,
                             f"{what}: rank 1's MoE combine partials dropped", failures)
            router = max(x[rung]["router_err"] for x in outs)
            _read(router, ROUTER_TOL, f"{what}: router logits vs torch.matmul", failures)
            router_fault = _planted(min(x[rung]["router_fault"] for x in outs), ROUTER_TOL,
                                    f"{what}: router with its last K chunk dropped", failures)
            flips = routing_flips([r.cpu() for r in g["routes"]],
                                  [r.cpu() for r in own_routes])
            suffix = "" if rung == "dense" else f"[{rung}]"
            for r, x in enumerate(outs):
                b5 = sum(c for k, c in x[rung]["launches"].items()
                         if k.startswith("grouped_streamk") and k.endswith(suffix))
                if x[rung]["groups"] != [32] or not b5:
                    failures.append(f"{what} rank {r}: grouped dispatches at G "
                                    f"{x[rung]['groups']}, {b5} B5 launches (want G = 32)")
            rec[rung] = dict(replayed_rel=rel, own_rel=own_rel, first_own_rel=first_rel,
                             tol=tol, fault_rel=fault,
                             router_err=router, router_fault=router_fault, flips=flips,
                             groups=g["groups"], launches=[x[rung]["launches"] for x in outs],
                             decode_split=[x[rung]["split"] for x in outs])
            log(f"{what}: logits vs the one-rank torch backend, max|diff| / max|logit|: the (4, "
                f"{tokens.shape[1]}) batch with routing replayed {rel:.3e}, on its own routing "
                f"{own_rel:.3e}; the first prompt ({first_prompt.shape[1]} tokens) on its own "
                f"routing {first_rel:.3e} (limit {tol} on the "
                f"{'replayed' if rung == 'dense' else 'first prompt'} reading); planted fault "
                f"{fault:.3e}; router {router:.3e} (planted {router_fault:.3e}); routing flips "
                f"against the one-rank routing {flips['assignments']} assignments, "
                f"{flips['token_sets']} token sets; B5 at G {g['groups']}, launches "
                f"{rec[rung]['launches']}")
            gc.collect()
            torch.cuda.empty_cache()
    del base
    return rec


def first_flip_margin(model, params, prompts, got, want):
    """Where two runs' greedy tokens first differ (request by request), the
    one-rank ``cuda`` logits' top-2 margin over max|logit| at that position
    (the caller's weights, no plan); None when they agree."""
    import torch

    from repro_torch.core.gemm import gemm_context

    for r, (a, b) in enumerate(zip(got, want)):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                pre = torch.as_tensor(np.concatenate([prompts[r], a[:i]]).astype(np.int64),
                                      device="cuda")[None]
                with gemm_context(backend="cuda"):
                    logits, _ = model.prefill(params, pre)
                top = torch.topk(logits[0, -1].float(), 2)
                return dict(request=r, position=i, tokens=[x, y],
                            top2=top.indices.tolist(),
                            margin=(top.values[0] - top.values[1]).item()
                            / logits[0, -1].float().abs().max().item())
    return None


def phase11_data(outs, failures):
    """Phase 11 (c): granite-8b on (2, 1) against this process's one-rank
    runs at the same depth: the prefill and decode logits against the
    ``torch`` backend at ``LOGITS_TOL``, each rank's decode keys against the
    one-rank plan's (``serve_gemm_div`` at 4 slots: M = 2), the engine's
    greedy tokens against a one-rank engine's (the first differing position
    read as W1's), a decode step's collectives against the dry run's (2, 1)
    cell (a planted extra all-gather must read as a disagreement)."""
    import torch

    from repro_torch.core.gemm import gemm_context
    from repro_torch.dist.sharding import ShardingPlan, use_plan
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve.engine import serve_gemm_div

    model = _granite_at(MR11_DATA_LAYERS)
    tokens = _mr_tokens(model.cfg.vocab_size, "cuda")
    s = tokens.shape[1]
    pos = torch.full((tokens.shape[0],), s, device="cuda")
    g = outs[0]
    what = f"phase 11 (c) granite-8b x {MR11_DATA_LAYERS} on (2, 1)"
    with torch.no_grad():
        params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
        with use_plan(ShardingPlan(MeshShape((MR_RANKS, 1), ("data", "model")))):
            div = serve_gemm_div(model, N_SLOTS)
            with gemm_context(backend="torch") as ctx:
                want, cache = model.prefill(params, tokens, max_seq=s + 1, div=div)
                n0 = len(ctx.log)
                want_step, _ = model.decode_step(params, cache, g["next"].cuda(), pos, div=div)
            plan_keys = _decode_keys(ctx.log[n0:])
        del cache
        engine = ServeEngine(model, params, ServeConfig(n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                                        eos=-1), backend="cuda")
        prompts = serve_prompts(model.cfg.vocab_size)
        for p in prompts:
            engine.submit(p, max_new_tokens=MR11_NEW)
        one = [r.out_tokens for r in sorted(engine.run(), key=lambda r: r.uid)]
        flip = None if one == g["tokens"] else first_flip_margin(model, params, prompts,
                                                                 g["tokens"], one)
    del params, engine
    tol = LOGITS_TOL["granite-8b"]
    readings = {key: _read(_rel(g[key], ref), tol, f"{what} {key} logits", failures)
                for key, ref in (("prefill", want), ("decode", want_step))}
    if div != {"batch": MR_RANKS, "model": 1}:
        failures.append(f"{what}: the one-rank plan's divisors {div}")
    same_keys = [o["keys"] == plan_keys for o in outs]
    if not all(same_keys):
        failures.append(f"{what}: decode keys {[o['keys'] for o in outs]} vs the one-rank "
                        f"plan's {plan_keys}")
    if not all(k.split(":")[1].startswith(f"({N_SLOTS // MR_RANKS},") for k in plan_keys):
        failures.append(f"{what}: decode keys not at M = {N_SLOTS // MR_RANKS}: {plan_keys}")
    if flip is not None and not flip["margin"] <= readings["decode"]:
        failures.append(f"{what}: greedy tokens differ from the one-rank engine's at a margin "
                        f"{flip['margin']:.3e} above the logits' reading")
    if [o["own_slots"] for o in outs] != [[r * 2, r * 2 + 2] for r in range(MR_RANKS)]:
        failures.append(f"{what}: slots owned {[o['own_slots'] for o in outs]}")
    art = dryrun.lower_cell("granite-8b", "decode_32k", False, mesh_shape=(MR_RANKS, 1),
                            config_overrides={"n_layers": MR11_DATA_LAYERS},
                            shape_overrides={"global_batch": N_SLOTS, "seq_len": MAX_SEQ})
    coll = g["collectives"]
    same = coll["per_decode_step"] == art["collectives"] and not coll["uneven_ops"]
    planted = json.loads(json.dumps(art["collectives"]))
    planted["all-gather"]["count"] += 1
    if not same:
        failures.append(f"{what}: a decode step's collectives {coll['per_decode_step']} vs the "
                        f"dry run's {art['collectives']}")
    if coll["per_decode_step"] == planted:
        failures.append(f"{what}: the planted extra all-gather went unseen")
    for r, o in enumerate(outs):
        if not (o["launches"].get("dp_gemm_region") or o["launches"].get("streamk_phase1")):
            failures.append(f"{what}: no GEMM kernel launched on rank {r}")
    rec = dict(layers=MR11_DATA_LAYERS, logits_rel=readings, tol=tol, keys=plan_keys,
               same_keys=same_keys,
               tokens=g["tokens"], one_rank_tokens=one, tokens_equal=one == g["tokens"],
               first_flip=flip, collectives=coll, dryrun_collectives=art["collectives"],
               same_collectives=same, launches=[o["launches"] for o in outs],
               decode_split=[o["split"] for o in outs], cache_rows=g["cache_rows"])
    log(f"{what}: 2 slots a rank (cache rows {g['cache_rows']}); logits vs the one-rank torch "
        f"backend: prefill {readings['prefill']:.3e}, decode {readings['decode']:.3e} (limit "
        f"{tol}); decode keys equal to the one-rank plan's (M = {N_SLOTS // MR_RANKS}): "
        f"{same_keys}; greedy tokens equal to a one-rank engine's: {rec['tokens_equal']} "
        f"(first flip {flip}); a decode step's collectives {coll['per_decode_step']} == the dry "
        f"run's: {same}; launches {rec['launches']}; a warm step by rank {rec['decode_split']}")
    return rec


def phase11_paged(outs, failures):
    """Phase 11 (d): the paged engine on (1, 2) against this process's
    one-rank paged engine at the same depth: the greedy tokens equal, every
    decode step's logits at ``LOGITS_TOL`` against a one-rank run fed the
    ranks' tokens, the gather's device ms per rank."""
    import torch

    from repro_torch.serve import PagedServeConfig, PagedServeEngine, disable_graphs

    model = _granite_at(MR11_LAYERS)
    g = outs[0]
    what = f"phase 11 (d) granite-8b x {MR11_LAYERS} --paged on (1, {MR_RANKS})"

    def run(forced=None):
        engine = PagedServeEngine(model, params, PagedServeConfig(
            page_size=MR11_PAGE, max_pages=N_SLOTS * MAX_SEQ // MR11_PAGE, max_active=N_SLOTS,
            max_seq=MAX_SEQ, eos=-1), backend="cuda")
        for p in serve_prompts(model.cfg.vocab_size):
            engine.submit(p, max_new_tokens=MR11_NEW)
        # eager, as the ranks' engines run: the tap reads every step's logits on the host,
        # which a captured step cannot
        with disable_graphs(), decode_logits_log(model) as steps, sampled_log(engine, forced):
            done = sorted(engine.run(), key=lambda r: r.uid)
        return [r.out_tokens for r in done], steps

    with torch.no_grad():
        params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
        one, _ = run()
        _, forced_steps = run(g["sampled"])
    del params
    tol = LOGITS_TOL["granite-8b"]
    same_inputs = len(forced_steps) == len(g["steps"]) and all(
        torch.equal(a[0], b[0]) for a, b in zip(forced_steps, g["steps"]))
    if not same_inputs:
        failures.append(f"{what}: the one-rank run fed the ranks' tokens took other inputs")
    rel = max((_rel(b[1], a[1]) for a, b in zip(forced_steps, g["steps"])), default=math.inf)
    _read(rel, tol, f"{what}: decode logits vs the one-rank paged engine", failures)
    if one != g["tokens"]:
        failures.append(f"{what}: greedy tokens {g['tokens']} vs the one-rank paged run's {one}")
    heads = [o["kv_heads"] for o in outs]
    if heads != [model.cfg.n_kv_heads // MR_RANKS] * MR_RANKS:
        failures.append(f"{what}: the pools hold {heads} kv heads")
    rec = dict(logits_rel=rel, tol=tol, tokens_equal=one == g["tokens"], kv_heads=heads,
               gather_ms=[o["gather_ms"] for o in outs], gather_bytes=g["gather_bytes"],
               launches=[o["launches"] for o in outs], metrics=g["metrics"],
               decode_steps=len(g["steps"]))
    log(f"{what}: greedy tokens equal to the one-rank paged run: {rec['tokens_equal']}; "
        f"{rec['decode_steps']} decode steps' logits vs the one-rank run on the ranks' tokens, "
        f"max|diff| / max|logit| {rel:.3e} (limit {tol}); kv heads a rank {heads}; the gather "
        f"of a 4 x {MAX_SEQ} view, {g['gather_bytes'] / 1e6:.1f} MB: "
        f"{[round(m, 5) for m in rec['gather_ms']]} ms by rank")
    return rec


def phase_serve_ranks(rank_outs, clis, failures):
    """Phase 11: the serve CLI's configurations under a plan across two ranks
    on the one card over gloo: (a) granite-8b quantized (int8-dynamic, int4)
    on (1, 2), (b) olmoe-1b-7b on its default MoE dispatch, dense and int8,
    (c) granite-8b on the data axis (2, 1), (d) granite-8b ``--paged`` on
    (1, 2). The rank parts ran in the ranks started before phase 5 (``rank_outs``);
    this process runs (a)'s CLI and every one-rank reference."""
    import torch

    t0 = time.perf_counter()
    rec = {"cli": phase11_cli(clis, failures)}
    if rank_outs is None:
        failures.append("phase 11: the rank program gave no output")
        return rec
    for key, part in (("quant", phase11_quant), ("olmoe", phase11_olmoe), ("data", phase11_data),
                      ("paged", phase11_paged)):
        gc.collect()
        torch.cuda.empty_cache()
        try:
            rec[key] = part([r[f"serve11_{key}"] for r in rank_outs], failures)
        except Exception as e:  # record it and go on: the run reports every breach
            failures.append(f"phase 11 {key}: {type(e).__name__}: {e}")
            log(f"phase 11 {key}: {traceback.format_exc()}")
    rec["rank_seconds"] = [r["serve11_seconds"] for r in rank_outs]
    rec["seconds"] = time.perf_counter() - t0
    log(f"phase 11 (serving across ranks under a plan, two processes on one card over gloo): "
        f"{rec['seconds']:.1f}s here, {rec['rank_seconds']} s in the rank program")
    return rec


def serve11_launches(rec):
    """Phase 11's launches by run, each a list of the ranks' counters."""
    out = {}
    for rung, run in (rec.get("cli") or {}).items():
        if run.get("launches_by_rank"):
            out[f"cli_{rung}"] = run["launches_by_rank"]
    for key in ("quant", "olmoe"):
        for rung, run in (rec.get(key) or {}).items():
            if isinstance(run, dict) and "launches" in run:
                out[f"{key}_{rung}"] = run["launches"]
    for key in ("data", "paged"):
        if rec.get(key):
            out[key] = rec[key]["launches"]
    return out


# ---------------------------------------------------------------------------
# Phase 12: the SSM, hybrid, VLM and encoder-decoder families across ranks
# ---------------------------------------------------------------------------

#: phase 12's cells at full width: (arch, layers; None: full depth). llava-next-34b is cut
#: to 8 of 60 layers: two ranks and the one-rank reference share the card
MR12_CELLS = (("mamba2-1.3b", None), ("zamba2-1.2b", None), ("llava-next-34b", 8),
              ("whisper-large-v3", None))
#: the rows of llava's image requests and whisper's audio requests, llava's text tokens
#: after its patches, whisper's decoder prompt
MR12_ROWS, MR12_TEXT, MR12_PROMPT = 2, 32, 8


def _mr12_model(arch, layers):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch)
    return build_model(dataclasses.replace(cfg, n_layers=layers) if layers else cfg)


def mr12_inputs(cfg):
    """(tokens, the family's extra input or None, the prompt's length) on the card, seeded:
    the four served prompts cut to the shortest (the SSM and the hybrid); ``MR12_ROWS``
    image requests, ``n_patches`` patch embeddings at the token embeddings' scale before
    ``MR12_TEXT`` text tokens (the VLM; ``image_request_check``'s layout); ``MR12_ROWS``
    audio requests of ``enc_frames`` standard-normal frames and an ``MR12_PROMPT``-token
    decoder prompt (the encoder-decoder)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(12)
    rng = np.random.default_rng(12)
    if cfg.family == "vlm":
        p = cfg.n_patches
        text = rng.integers(1, cfg.vocab_size, (MR12_ROWS, MR12_TEXT))
        tokens = torch.as_tensor(np.concatenate([text, np.zeros((MR12_ROWS, p), text.dtype)],
                                                axis=1), device="cuda")
        patches = (torch.randn(MR12_ROWS, p, cfg.d_model, generator=gen, device="cuda")
                   / math.sqrt(cfg.vocab_size)).to(torch.bfloat16)
        return tokens, patches, tokens.shape[1]
    if cfg.family == "encdec":
        frames = torch.randn(MR12_ROWS, cfg.enc_frames, cfg.d_model, generator=gen,
                             device="cuda").to(torch.bfloat16)
        tokens = torch.as_tensor(rng.integers(1, cfg.vocab_size, (MR12_ROWS, MR12_PROMPT)),
                                 device="cuda")
        return tokens, frames, MR12_PROMPT
    tokens = _mr_tokens(cfg.vocab_size, "cuda")
    return tokens, None, tokens.shape[1]


def mr12_prefill(model, params, tokens, extra, max_seq):
    """The family's prefill: the VLM's with its patches, the encoder-decoder's of its
    frames."""
    if model.cfg.family == "encdec":
        return model.prefill(params, extra, tokens, max_seq=max_seq)
    kw = {"patch_embeds": extra} if model.cfg.family == "vlm" else {}
    return model.prefill(params, tokens, max_seq=max_seq, **kw)


@contextmanager
def shifted_conv_shard(rank):
    """The planted fault of a Mamba2 block across ranks: rank 1 convolves the channels one
    to the left of its shard (its conv weights on its neighbour's last channel and all
    but its own last), in every layer."""
    import dataclasses

    from repro_torch.models import ssd

    real = ssd.ranked_layout

    def shifted(cfg, plan):
        lay = real(cfg, plan)
        if rank == 1:
            lay = dataclasses.replace(lay, chans=(lay.chans[0] - 1, lay.chans[1]))
        return lay

    ssd.ranked_layout = shifted
    try:
        yield
    finally:
        ssd.ranked_layout = real


def _cpu_trace(trace):
    return [(x.cpu(), y.cpu()) for x, y in trace]


def _cache_shards(model, plan, cache, rows, max_seq):
    """This rank's decode cache on the host: each leaf by its path, beside the dim its
    spec splits over ``model`` (None: whole on every rank)."""
    from repro_torch.dist.sharding import axes_of, spec_items
    from repro_torch.utils.trees import tree_items

    specs = dict(spec_items(model.cache_specs(rows, max_seq)))
    out = {}
    for name, leaf in tree_items(cache):
        parts = plan.spec_for(specs[name])
        dim = next((d for d, part in enumerate(parts) if "model" in axes_of(part)), None)
        out[name] = (leaf.to(device="cpu", copy=True), dim)
    return out


def _joined_cache(shards):
    """A decode cache on the card from ranks' :func:`_cache_shards`, in rank order: each
    split leaf their shards concatenated, each whole leaf the first's (of one rank's
    shards: that rank's own cache; of every rank's: the one-rank cache)."""
    import torch

    tree = {}
    for name, (leaf, dim) in shards[0].items():
        full = leaf if dim is None else torch.cat([r[name][0] for r in shards], dim)
        *path, key = name.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[key] = full.to(device="cuda", copy=True)  # each call a fresh cache
    return tree


def mr12_family(rank, arch, layers):
    """Phase 12 (b) on each rank: ``arch`` at full width (cut to ``layers``) on (1, 2): a
    prefill (the VLM's image requests, the encoder-decoder's frames) and a greedy decode
    step through the kernels, the gathered logits, each layer's input and output and the
    prefill's cache shards (the SSM and the hybrid), the launches and the decode step's
    collectives, a warm step's split; then the prefill again under the planted fault:
    rank 1's conv shard shifted by one channel (the SSM and the hybrid; also the decode
    step alone, from the sound prefill's cache), else rank 1's partial of the second
    all-reduce zeroed."""
    import torch

    from repro_torch.core.gemm import gemm_context
    from repro_torch.dist.collectives import record
    from repro_torch.dist.sharding import ShardingPlan, use_plan
    from repro_torch.kernels.common import reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve.graphs import step_mode

    t0 = time.perf_counter()
    model = _mr12_model(arch, layers)
    ssm = model.cfg.family in ("ssm", "hybrid")
    tokens, extra, s = mr12_inputs(model.cfg)
    pos = torch.full((tokens.shape[0],), s, device="cuda")
    plan = ShardingPlan(make_host_mesh(model=MR_RANKS))
    with use_plan(plan), torch.no_grad():
        params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
        reset_launch_counts()
        with layer_trace(ssm) as trace, gemm_context(backend="cuda"):
            logits, cache = mr12_prefill(model, params, tokens, extra, s + 1)
        nxt = logits[:, -1].argmax(-1)[:, None]
        # the decode steps write the cache in place: the faulty one starts from this copy
        shards = _cache_shards(model, plan, cache, tokens.shape[0], s + 1) if ssm else None
        with record() as coll, layer_trace(ssm) as step_trace, gemm_context(backend="cuda"):
            step, _ = model.decode_step(params, cache, nxt, pos)
        torch.cuda.synchronize()
        launches = _mr_launches()
        with gemm_context(backend="cuda"):
            split = mr_decode_split(rank, lambda: model.decode_step(params, cache, nxt, pos),
                                    iters=2)
        del cache
        fault = shifted_conv_shard(rank) if ssm else planted_zero_all_reduce(rank, call=1)
        with fault, layer_trace(ssm) as bad_trace, gemm_context(backend="cuda"):
            bad, _ = mr12_prefill(model, params, tokens, extra, s + 1)
        bad_step = bad_step_trace = None
        if ssm:
            cache = _joined_cache([shards])
            with shifted_conv_shard(rank), layer_trace() as bad_step_trace, \
                    gemm_context(backend="cuda"):
                bad_step, _ = model.decode_step(params, cache, nxt, pos)
            del cache
        torch.cuda.synchronize()
        mode = step_mode("cuda")  # phase 14 (f): under the plan
    del params
    keep = rank == 0  # the gathered logits and the residual stream are whole on every rank
    seconds = time.perf_counter() - t0
    log(f"phase 12 (b) {arch} on rank {rank}: {seconds:.1f}s")
    return dict(prefill=logits.cpu(), decode=step.cpu(), next=nxt.cpu(), fault=bad.cpu(),
                launches=launches, collectives=coll.summary(), split=split, seconds=seconds,
                step_mode=mode, trace=_cpu_trace(trace) if keep else None,
                fault_trace=_cpu_trace(bad_trace) if keep else None, cache=shards,
                step_trace=_cpu_trace(step_trace) if keep else None,
                fault_step=None if bad_step is None else bad_step.cpu(),
                fault_step_trace=_cpu_trace(bad_step_trace) if keep and ssm else None)


def phase12_cli(run, failures):
    """Phase 12 (a): the serve CLI under ``torch.distributed.run`` on 2 ranks
    (``--mesh-model 2``; run by ``rank_clis`` beside phase 10 (a)'s), mamba2-1.3b at full width
    and depth, 4 requests: exit 0, 4/4, B1 or B2 launched on each rank, a decode step's
    collectives equal to the dry run's (1, 2) decode cell (a planted extra all-gather must
    read as a disagreement), the greedy tokens beside the one-rank CLI's in this process."""
    import tempfile

    from repro_torch.launch import dryrun
    from repro_torch.launch import serve as t_serve

    arch = "mamba2-1.3b"
    what = f"phase 12 (a) serve CLI {arch} on (1, {MR_RANKS})"
    base = ["--arch", arch, "--preset", "full", "--requests", "4", "--slots", str(N_SLOTS),
            "--max-seq", str(MAX_SEQ), "--max-new-tokens", str(MR11_NEW)]
    rc, seconds, err, summary = run
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        one = os.path.join(tmp, "one.json")
        t0 = time.perf_counter()
        one_rc = t_serve.main(base + ["--summary-json", one])
        single = json.load(open(one)) if os.path.exists(one) else None
        one_s = time.perf_counter() - t0
    if rc != 0 or summary is None:
        failures.append(f"{what}: exit {rc}; stderr {err[-3000:]}")
        log(f"{what}: exit {rc}\n{err[-3000:]}")
        return dict(rc=rc, seconds=seconds)
    if summary["completed"] != 4:
        failures.append(f"{what}: {summary['completed']}/4 requests")
    for r, by in enumerate(summary["launches_by_rank"]):
        if not (by.get("dp_gemm_region") or by.get("streamk_phase1")):
            failures.append(f"{what}: neither B1 nor B2 launched on rank {r}: {by}")
    art = dryrun.lower_cell(arch, "decode_32k", False, mesh_shape=(1, MR_RANKS),
                            shape_overrides={"global_batch": N_SLOTS, "seq_len": MAX_SEQ})
    coll = summary["collectives"]
    same = coll["per_decode_step"] == art["collectives"] and not coll["uneven_ops"]
    planted = json.loads(json.dumps(art["collectives"]))
    planted["all-gather"]["count"] += 1
    if not same:
        failures.append(f"{what}: a decode step's collectives {coll['per_decode_step']} "
                        f"(uneven {coll['uneven_ops']}) vs the dry run's {art['collectives']}")
    if coll["per_decode_step"] == planted:
        failures.append(f"{what}: the planted extra all-gather went unseen")
    if one_rc != 0 or single is None:
        failures.append(f"{what}: the one-rank CLI exited {one_rc}")
    tokens = summary["workers"][0]["out_tokens"]
    ref = None if single is None else single["workers"][0]["out_tokens"]
    agree = None if ref is None else sum(a == b for ra, rb in zip(tokens, ref)
                                         for a, b in zip(ra, rb))
    steps = max(coll["decode_steps"], 1)
    log(f"{what}: exit {rc}, {summary['completed']}/4, launches by rank "
        f"{summary['launches_by_rank']}; a decode step's collectives {coll['per_decode_step']} "
        f"== the dry run's: {same}; decode {coll['decode_ms'] / steps:.2f} ms a step, "
        f"{coll['collective_ms'] / steps:.2f} of it in collectives; greedy tokens equal to the "
        f"one-rank CLI's: {agree}/{4 * MR11_NEW} ({seconds:.1f}s; one rank {one_s:.1f}s)")
    return dict(rc=rc, seconds=seconds, completed=summary["completed"],
                launches_by_rank=summary["launches_by_rank"], collectives=coll,
                dryrun_collectives=art["collectives"], same_collectives=same, tokens=tokens,
                one_rank_tokens=ref, tokens_agree=agree, one_rank_seconds=one_s)


def _on_card(trace):
    return [(x.cuda(), y.cuda()) for x, y in trace]


def phase12_family(arch, layers, outs, failures):
    """Phase 12 (b) for one family: the ranks' outputs against this process's one-rank
    ``cuda`` run on the same weights and inputs, at ``LOGITS_TOL``: the prefill and the
    decode step fed the ranks' token (the SSM and the hybrid layer by layer, each layer of
    the one-rank run fed the ranks' input to it, ``layer_replayed_diff``, the decode step
    from the ranks' prefill cache with their shards joined, since the state carries the
    prefill's spread; the end-to-end readings reported); the planted faults read the same
    way, at least 3 times the limit (the SSM and the hybrid: the prefill's and, apart, the
    decode step's); a decode step's collectives equal to the dry run's (1, 2) cell op by
    op; B1 or B2 launched on each rank."""
    import torch

    from repro_torch.core.gemm import gemm_context
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    model = _mr12_model(arch, layers)
    cfg = model.cfg
    ssm = cfg.family in ("ssm", "hybrid")
    tokens, extra, s = mr12_inputs(cfg)
    pos = torch.full((tokens.shape[0],), s, device="cuda")
    g = outs[0]
    tol = LOGITS_TOL[arch]
    what = f"phase 12 (b) {arch}" + (f" x {layers}" if layers else "") + f" on (1, {MR_RANKS})"
    with torch.no_grad():
        params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))

        def prefill():
            return mr12_prefill(model, params, tokens, extra, s + 1)[0]

        with gemm_context(backend="cuda"):
            want, cache = mr12_prefill(model, params, tokens, extra, s + 1)
            want_step, _ = model.decode_step(params, cache, g["next"].cuda(), pos)
        del cache
        e2e = _rel(g["prefill"], want)
        decode = _rel(g["decode"], want_step)
        layer_rel = fault_layers = step_rel = step_fault = e2e_decode = fault_step = None
        if ssm:
            shards = [o["cache"] for o in outs]

            def step():  # from the ranks' prefill cache, joined: the step writes it in place
                return model.decode_step(params, _joined_cache(shards), g["next"].cuda(),
                                         pos)[0]

            layer_rel = layer_replayed_diff(prefill, _on_card(g["trace"]), g["prefill"].cuda(),
                                            backend="cuda")
            held = _read(max(layer_rel), tol, f"{what} prefill logits, each layer fed the "
                         "ranks' input", failures)
            step_rel = layer_replayed_diff(step, _on_card(g["step_trace"]), g["decode"].cuda(),
                                           backend="cuda")
            e2e_decode, decode = decode, _read(max(step_rel), tol, f"{what} decode logits, each "
                                               "layer fed the ranks' input and cache", failures)
            fault_layers = layer_replayed_diff(prefill, _on_card(g["fault_trace"]),
                                               g["fault"].cuda(), backend="cuda")
            fault = _planted(max(fault_layers), tol, f"{what} (rank 1's conv shard shifted by "
                             "one channel)", failures)
            step_fault = layer_replayed_diff(step, _on_card(g["fault_step_trace"]),
                                             g["fault_step"].cuda(), backend="cuda")
            fault_step = _planted(max(step_fault), tol, f"{what} decode step (rank 1's conv "
                                  "shard shifted by one channel)", failures)
        else:
            held = _read(e2e, tol, f"{what} prefill logits", failures)
            _read(decode, tol, f"{what} decode logits", failures)
            fault = _planted(_rel(g["fault"], want), tol, f"{what} (rank 1's partial of the "
                             "second all-reduce zeroed)", failures)
    del params
    art = dryrun.lower_cell(arch, "decode_32k", False, mesh_shape=(1, MR_RANKS),
                            config_overrides={"n_layers": layers} if layers else None,
                            shape_overrides={"global_batch": tokens.shape[0], "seq_len": s + 1})
    same = [o["collectives"] == art["collectives"] for o in outs]
    planted = json.loads(json.dumps(art["collectives"]))
    planted["all-reduce"]["count"] += 1
    if not all(same):
        failures.append(f"{what}: a decode step's collectives {[o['collectives'] for o in outs]} "
                        f"vs the dry run's {art['collectives']}")
    if any(o["collectives"] == planted for o in outs):
        failures.append(f"{what}: the planted extra all-reduce went unseen")
    launches = [{k: o["launches"].get(k, 0) for k in ("dp_gemm_region", "streamk_phase1")}
                for o in outs]
    for r, by in enumerate(launches):
        if not any(by.values()):
            failures.append(f"{what}: neither B1 nor B2 launched on rank {r}")
    rec = dict(layers=cfg.n_layers, rows=int(tokens.shape[0]), prompt=s, tol=tol,
               prefill_rel=held, prefill_e2e_rel=e2e, decode_rel=decode,
               decode_e2e_rel=e2e_decode, layer_replayed=layer_rel,
               decode_layer_replayed=step_rel, fault_rel=fault, fault_layers=fault_layers,
               decode_fault_rel=fault_step, decode_fault_layers=step_fault,
               collectives=g["collectives"], dryrun_collectives=art["collectives"],
               same_collectives=same, launches=launches, all_launches=[o["launches"] for o in outs],
               decode_split=[o["split"] for o in outs], seconds=time.perf_counter() - t0)
    log(f"{what}: prefill logits vs one rank {held:.3e}"
        + (f" (each layer fed the ranks' input; end to end {e2e:.3e})" if ssm else "")
        + f", decode {decode:.3e}"
        + (f" (each layer fed the ranks' input and cache; end to end {e2e_decode:.3e})"
           if ssm else "")
        + f" (limit {tol}); fault {fault:.3e}"
        + (f", in the decode step {fault_step:.3e}" if ssm else "")
        + "; a decode step's collectives "
        f"{g['collectives']} == the dry run's: {same}; B1/B2 launches by rank {launches}; a "
        f"warm step by rank {rec['decode_split']} ({rec['seconds']:.1f}s)")
    return rec


def phase_families_ranks(rank_outs, cli, failures):
    """Phase 12: the SSM, hybrid, VLM and encoder-decoder families across two ranks on the
    one card over gloo: (a) mamba2-1.3b through the serve CLI, (b) each of ``MR12_CELLS``
    through the model's prefill and decode step. The rank parts ran in the ranks started
    before phase 5 (``rank_outs``); this process runs (a)'s CLIs and every one-rank
    reference."""
    import torch

    t0 = time.perf_counter()
    rec = {"cli": phase12_cli(cli, failures)}
    if rank_outs is None:
        failures.append("phase 12: the rank program gave no output")
        return rec
    for arch, layers in MR12_CELLS:
        gc.collect()
        torch.cuda.empty_cache()
        try:
            rec[arch] = phase12_family(arch, layers, [r[f"fam12_{arch}"] for r in rank_outs],
                                       failures)
        except Exception as e:  # record it and go on: the run reports every breach
            failures.append(f"phase 12 {arch}: {type(e).__name__}: {e}")
            log(f"phase 12 {arch}: {traceback.format_exc()}")
    rec["rank_seconds"] = [r["fam12_seconds"] for r in rank_outs]
    rec["seconds"] = time.perf_counter() - t0
    log(f"phase 12 (the SSM, hybrid, VLM and encoder-decoder families across ranks, two "
        f"processes on one card over gloo): {rec['seconds']:.1f}s here, {rec['rank_seconds']} s "
        f"in the rank program")
    return rec


def families12_launches(rec):
    """Phase 12's launches by run, each a list of the ranks' counters."""
    out = {}
    if (rec.get("cli") or {}).get("launches_by_rank"):
        out["cli_mamba2-1.3b"] = rec["cli"]["launches_by_rank"]
    for arch, _ in MR12_CELLS:
        if isinstance(rec.get(arch), dict):
            out[arch] = rec[arch]["all_launches"]
    return out


# ---------------------------------------------------------------------------
# Phase 13: repro's production sharding rules across ranks
# ---------------------------------------------------------------------------

#: (a) granite-8b decode on (1, 2) under the decode rule repro's ``rules_for_cell``
#: gives the production mesh, where its 8 kv heads do not divide model (16): the cache's
#: positions over (pod, data, model), the kv heads whole (installed as its dry run's
#: ``--rules``). Full width, depth cut to ``MR13_LAYERS`` of 36; 4 slots, one request of
#: each of ``MR13_PROMPTS`` tokens prefilled into a cache of ``MR13_SEQ`` positions (each
#: rank holds half: rows on both), ``MR13_STEPS`` greedy decode steps
MR13_RULES = {"kv_heads": None, "kv_seq": ("pod", "data", "model")}
MR13_LAYERS, MR13_SEQ, MR13_STEPS = 4, 2048, 2
MR13_PROMPTS = (900, 1300, 1700, 2000)
#: (b) zamba2-1.2b, one row, under long_500k's rule on (2, 1) (kv_seq on data, the batch
#: demoted): full width, depth cut to ``MR13_ZAMBA_LAYERS`` of 38 (its shared attention at
#: two of them), the 524288-position cache cut to ``MR13_LONG_SEQ``, a prompt of
#: ``MR13_LONG_PROMPT`` tokens (the rank holding positions 2176 on holds its last 1920 and
#: the decoded token's row)
MR13_ZAMBA_LAYERS, MR13_LONG_SEQ, MR13_LONG_PROMPT = 12, 4352, 4096
#: (c) granite-8b trained under train_4k's rule (seq on model) on (1, 2), then Adafactor on
#: (1, 2) and on (2, 1) (FSDP over data): full width, depth cut to ``MR13_TRAIN_LAYERS``,
#: 2 x 2048 tokens (phase 8's 4096, in two rows so that (2, 1) splits them)
MR13_TRAIN_LAYERS, MR13_TRAIN_ROWS, MR13_TRAIN_SEQ = 2, 2, 2048
#: the optimizers' schedule in (c), the dry run's
MR13_LR = 1e-4


def _clone_tree(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


@contextmanager
def dropped_partial(rank):
    """The planted fault of a decode step under ``kv_seq``: rank 1's partial softmax
    (its denominators and outputs) never reaches the combine (the exchange still
    happens, so the ranks stay in step)."""
    from repro_torch.models import layers

    real = layers.combine_partials

    def dropped(m, l, acc, axes):
        if rank == 1:
            l, acc = l * 0, acc * 0
        return real(m, l, acc, axes)

    layers.combine_partials = dropped
    try:
        yield
    finally:
        layers.combine_partials = real


@contextmanager
def wrong_slice_scatter(rank):
    """The planted fault of a sequence-parallel step: rank 1's reduce-scatters keep the
    neighbouring rank's slice of the sum in place of its own."""
    import dataclasses

    from repro_torch.dist import collectives

    raw = collectives.raw_reduce_scatter

    def faulty(x, ax, dim):
        if rank == 1:
            ax = dataclasses.replace(ax, index=(ax.index + 1) % ax.size)
        return raw(x, ax, dim)

    collectives.raw_reduce_scatter = faulty
    try:
        yield
    finally:
        collectives.raw_reduce_scatter = raw


def mr13_prompts(vocab):
    """The seeded requests of (a), one of each of ``MR13_PROMPTS`` tokens."""
    rng = np.random.default_rng(13)
    return [rng.integers(1, vocab, n) for n in MR13_PROMPTS]


def mr13_serve(model, params, prompts, feed=None):
    """(a)'s serving path: each request prefilled alone into a cache laid out for the 4
    slots (``cache_batch``, as the slot engine does) and copied into its slot, then
    ``MR13_STEPS`` decode steps of the 4 slots at their own positions. ``feed``: the
    tokens to decode (another run's greedy ones), else this run's greedy tokens. Returns
    each request's last prefill logits, each step's logits, the tokens fed, the cache
    after the prefills (a copy) and the first step's positions."""
    import torch

    from repro_torch.serve.engine import _place

    n = len(prompts)
    cache = model.init_cache(n, MR13_SEQ, device="cuda")
    last = []
    for slot, p in enumerate(prompts):
        logits, one = model.prefill(params, torch.as_tensor(p, device="cuda")[None],
                                    max_seq=MR13_SEQ, cache_batch=n)
        _place(cache, one, slot)
        last.append(logits[0, -1])
    prefill = torch.stack(last)
    pos = torch.as_tensor([len(p) for p in prompts], device="cuda")
    saved = _clone_tree(cache)
    nxt = prefill.argmax(-1)[:, None] if feed is None else feed[0].cuda()
    fed, steps = [nxt.cpu()], []
    for i in range(MR13_STEPS):
        logits, cache = model.decode_step(params, cache, nxt, pos + i)
        steps.append(logits[:, 0].cpu())
        if i + 1 < MR13_STEPS:
            nxt = logits[:, 0].argmax(-1)[:, None] if feed is None else feed[i + 1].cuda()
            fed.append(nxt.cpu())
    del cache
    return dict(prefill=prefill.cpu(), steps=steps, fed=fed, saved=saved, pos=pos)


def mr13_decode(rank):
    """Phase 13 (a) on each rank (module constants): the serving path through the kernels,
    the gathered logits, each rank's cache shapes and launches, a decode step's
    collectives, a warm step's split; the first decode step again with rank 1's partial
    dropped from the combine. Rank 0 then runs the one-rank ``cuda`` reference on the same
    weights, fed the ranks' tokens, and reads both."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.gemm import gemm_context
    from repro_torch.dist.collectives import record
    from repro_torch.dist.sharding import ShardingPlan, use_plan
    from repro_torch.kernels.common import reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve.graphs import step_mode

    t0 = time.perf_counter()
    model = _granite_at(MR13_LAYERS)
    prompts = mr13_prompts(model.cfg.vocab_size)
    plan = ShardingPlan(make_host_mesh(model=MR_RANKS), dict(MR13_RULES))
    with use_plan(plan), torch.no_grad():
        params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
        reset_launch_counts()
        with gemm_context(backend="cuda"):
            run = mr13_serve(model, params, prompts)
        torch.cuda.synchronize()
        launches = _mr_launches()
        first, pos = run["fed"][0].cuda(), run["pos"]
        cache = _clone_tree(run["saved"])
        with record() as coll, gemm_context(backend="cuda"):
            model.decode_step(params, cache, first, pos)
        with gemm_context(backend="cuda"):
            split = mr_decode_split(rank, lambda: model.decode_step(params, cache, first, pos),
                                    iters=2)
        with dropped_partial(rank), gemm_context(backend="cuda"):
            bad, _ = model.decode_step(params, _clone_tree(run["saved"]), first, pos)
        shapes = {k: tuple(v.shape) for k, v in cache["attn"].items()}
        mode = step_mode("cuda")  # phase 14 (f): under the plan
        del params, cache
    out = dict(launches=launches, collectives=coll.summary(), split=split, cache_shapes=shapes,
               step_mode=mode)
    if rank == 0:
        with torch.no_grad(), gemm_context(backend="cuda"):
            params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
            ref = mr13_serve(model, params, prompts, feed=run["fed"])
            del params
        out.update(prefill_rel=_rel(run["prefill"], ref["prefill"]),
                   decode_rel=max(_rel(a, b) for a, b in zip(run["steps"], ref["steps"])),
                   fault_rel=_rel(bad, ref["steps"][0][:, None]))
    del run
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 13 (a) on rank {rank}: {out['seconds']:.1f}s")
    return out


@contextmanager
def attn_trace():
    """Record, while the block runs, each cached attention call's input and output
    (``layers.attn_apply`` with a cache: a decode step's attention layers), in call
    order."""
    from repro_torch.models import layers

    real = layers.attn_apply
    trace = []

    def recording(p, x, cfg, **kw):
        out = real(p, x, cfg, **kw)
        if kw.get("cache") is not None:
            trace.append((x, out[0]))
        return out

    layers.attn_apply = recording
    try:
        yield trace
    finally:
        layers.attn_apply = real


def attn_replayed_diff(model, params, trace, cache, pos):
    """Each traced decode attention call of a hybrid (``attn_trace``) against the one-rank
    attention fed the same input and the same layer of ``cache`` (a whole cache before
    the step; copied, the call writes it): max|diff| over max|output|, call by call. The
    shared block's attention runs at the marked layers, in order."""
    import torch

    from repro_torch.core.gemm import gemm_context
    from repro_torch.models import layers

    marked = [i for i, on in enumerate(model.layer_flags()["use_attn"]) if on]
    out = []
    with torch.no_grad(), gemm_context(backend="cuda"):
        for i, (x, got) in zip(marked, trace):
            layer = {k: v[i].clone() for k, v in cache["attn"].items()}
            want, _ = layers.attn_apply(params["shared_attn"]["attn"], x, model.cfg, div={},
                                        positions=pos[:, None], cache=layer, cur_pos=pos)
            out.append(((got.float() - want.float()).abs().max()
                        / want.float().abs().max()).item())
    return out


def _whole_cache(cache, plan):
    """A decode cache split over ``kv_seq`` made whole on every rank (a collective): the
    attention leaves' positions all-gathered, the rest (whole already) as they are."""
    from repro_torch.dist.collectives import mesh_axis, raw_all_gather
    from repro_torch.dist.sharding import kv_seq_split

    split = kv_seq_split(plan, cache["attn"]["k"].shape[1])
    out = _clone_tree(cache)
    if split is not None:
        for key, leaf in cache["attn"].items():
            for a in reversed(split.axes):  # innermost axis first
                leaf = raw_all_gather(leaf, mesh_axis(a, plan.mesh), 2)
            out["attn"][key] = leaf
    return out


def mr13_long(rank):
    """Phase 13 (b) on each rank: zamba2-1.2b under long_500k's rule on (2, 1), one row:
    the prefill and a decode step through the kernels with each layer's input and output,
    the launches, the decode step's collectives and a warm step's split; the decode step
    again with rank 1's partial dropped from the combine. Rank 0 then holds them layer by
    layer against the one-rank ``cuda`` run on the same weights (``layer_replayed_diff``:
    the decode steps from the ranks' prefill cache made whole) and end to end."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.gemm import gemm_context
    from repro_torch.dist.collectives import record
    from repro_torch.dist.sharding import ShardingPlan, use_plan
    from repro_torch.kernels.common import reset_launch_counts
    from repro_torch.launch.dryrun import rules_for_cell
    from repro_torch.launch.mesh import MeshShape, make_host_mesh
    from repro_torch.models import SHAPES_BY_NAME

    t0 = time.perf_counter()
    model = _mr12_model("zamba2-1.2b", MR13_ZAMBA_LAYERS)
    rules = rules_for_cell(model.cfg, SHAPES_BY_NAME["long_500k"],
                           MeshShape((MR_RANKS, 1), ("data", "model")))
    plan = ShardingPlan(make_host_mesh(model=1), rules)
    rng = np.random.default_rng(13)
    tokens = torch.as_tensor(rng.integers(1, model.cfg.vocab_size, (1, MR13_LONG_PROMPT)),
                             device="cuda")
    pos = torch.full((1,), MR13_LONG_PROMPT, device="cuda")
    with use_plan(plan), torch.no_grad():
        params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
        reset_launch_counts()
        with layer_trace() as trace, gemm_context(backend="cuda"):
            logits, cache = model.prefill(params, tokens, max_seq=MR13_LONG_SEQ)
        nxt = logits[:, -1].argmax(-1)[:, None]
        saved = _clone_tree(cache)
        with record() as coll, layer_trace() as step_trace, attn_trace() as step_attn, \
                gemm_context(backend="cuda"):
            step, _ = model.decode_step(params, cache, nxt, pos)
        torch.cuda.synchronize()
        launches = _mr_launches()
        with gemm_context(backend="cuda"):
            split = mr_decode_split(rank, lambda: model.decode_step(params, cache, nxt, pos),
                                    iters=2)
        with dropped_partial(rank), layer_trace() as bad_trace, attn_trace() as bad_attn, \
                gemm_context(backend="cuda"):
            bad, _ = model.decode_step(params, _clone_tree(saved), nxt, pos)
        shapes = {k: tuple(v.shape) for k, v in saved["attn"].items()}
        whole = _whole_cache(saved, plan)
        del params, cache, saved
    out = dict(launches=launches, collectives=coll.summary(), split=split, cache_shapes=shapes,
               rules={k: list(v) if isinstance(v, tuple) else v for k, v in rules.items()})
    if rank == 0:
        with torch.no_grad():
            params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))

            def prefill():
                return model.prefill(params, tokens, max_seq=MR13_LONG_SEQ)[0]

            def decode():  # from the ranks' prefill cache, whole: the step writes it in place
                return model.decode_step(params, _clone_tree(whole), nxt, pos)[0]

            out["prefill_layers"] = layer_replayed_diff(prefill, trace, logits, backend="cuda")
            out["decode_layers"] = layer_replayed_diff(decode, step_trace, step, backend="cuda")
            out["fault_layers"] = layer_replayed_diff(decode, bad_trace, bad, backend="cuda")
            # the attention calls on their own: the combine's share of the stream is small
            # beside the residual over thousands of positions, so there a fault reads in full
            out["decode_attn"] = attn_replayed_diff(model, params, step_attn, whole, pos)
            out["fault_attn"] = attn_replayed_diff(model, params, bad_attn, whole, pos)
            with gemm_context(backend="cuda"):
                out["prefill_e2e"] = _rel(logits, prefill())
                out["decode_e2e"] = _rel(step, decode())
            del params
    del trace, step_trace, bad_trace, step_attn, bad_attn, whole
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 13 (b) on rank {rank}: {out['seconds']:.1f}s")
    return out


def _shard_diff(local, want, plan, specs):
    """The relative L2 distance, over the whole tree and across the ranks, of this rank's
    shards ``local`` ({path: tensor}) from ``want``, the same slices of the reference's
    tensors (``specs``: {path: ArraySpec}); each leaf counted once whatever the ranks that
    hold it (a collective: every rank calls it)."""
    import torch

    from repro_torch.dist.collectives import mesh_axis, raw_all_reduce
    from repro_torch.dist.sharding import axes_of

    sizes = {a: int(n) for a, n in plan.mesh.shape.items() if int(n) > 1}
    acc = torch.zeros(2, dtype=torch.float64, device="cuda")
    for name, got in local.items():
        held = {a for part in plan.spec_for(specs[name]) for a in axes_of(part)}
        copies = math.prod(n for a, n in sizes.items() if a not in held)
        ref = want[name].double()
        acc[0] += (got.double() - ref).square().sum() / copies
        acc[1] += ref.square().sum() / copies
    for a in sizes:
        acc = raw_all_reduce(acc, mesh_axis(a, plan.mesh))
    return math.sqrt(acc[0].item() / max(acc[1].item(), 1e-300))


def _opt_leaves(state, specs):
    """{path: (tensor, spec)} of an Adafactor state's masters and moments
    (``master/<param>``, ``v/<param>/vr``, ...), each beside its spec (``specs``: the
    parameters' {path: ArraySpec})."""
    from repro_torch.dist.sharding import moment_spec
    from repro_torch.utils.trees import tree_items

    out = {}
    for group in ("master", "v"):
        for name, t in tree_items(state[group]):
            parent, _, key = name.rpartition("/")
            spec = specs[name] if group == "master" else moment_spec(specs[parent], key)
            out[f"{group}/{name}"] = (t, spec)
    return out


def mr13_train(rank):
    """Phase 13 (c) on each rank: granite-8b under train_4k's rule. The ranks first run,
    one after the other, the one-rank ``cuda`` reference on the same weights and batch
    (the first step's loss and gradients, two AdamW steps, two Adafactor steps with their
    masters and moments), each keeping its slices of it. Then on (1, 2),
    sequence-parallel: the loss and the gradients, synchronised as the train step does,
    read against the reference's slices; the same with rank 1's reduce-scatters keeping
    the neighbour's slice (the planted fault); two AdamW train steps (the first's
    collectives), then a warm step's split. Then two Adafactor steps on (1, 2) and on
    (2, 1) (FSDP over data): the losses, and each rank's masters and factored moments
    against the reference's slices."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.gemm import gemm_context
    from repro_torch.data import SyntheticLMData
    from repro_torch.dist.collectives import record, sync_grads
    from repro_torch.dist.sharding import (ShardingPlan, local_rows, shard_leaf, spec_items,
                                           use_plan)
    from repro_torch.kernels.common import reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM
    from repro_torch.optim import constant, make_optimizer
    from repro_torch.train import init_train_state
    from repro_torch.train.trainer import make_train_step, take_grads, to_device_batch
    from repro_torch.utils.trees import tree_items

    t0 = time.perf_counter()
    model = LM(dataclasses.replace(get_config("granite-8b"), n_layers=MR13_TRAIN_LAYERS))
    specs = dict(spec_items(model.param_specs()))
    data = SyntheticLMData(model.cfg, batch=MR13_TRAIN_ROWS, seq_len=MR13_TRAIN_SEQ, seed=1)
    batch0 = to_device_batch(data.batch_at(0), "cuda")
    # every rank makes every group, in the same order
    plans = {"1x2": ShardingPlan(make_host_mesh(model=MR_RANKS), {"seq": "model"}),
             "2x1": ShardingPlan(make_host_mesh(model=1), {"seq": "model"})}

    def params_for():
        params = model.init_params("cuda", torch.Generator(device="cuda").manual_seed(0))
        for _, leaf in tree_items(params):
            leaf.requires_grad_(True)
        return params

    def steps(name, n, batch):
        """(the losses, the state, the first step's collectives, the step function) of
        ``n`` train steps on ``batch`` with optimizer ``name``."""
        opt = make_optimizer(name, constant(MR13_LR))
        state = init_train_state(model, opt, params_for())
        step = make_train_step(model, opt)
        losses, coll = [], None
        for i in range(n):
            with record() if i == 0 else nullcontext() as rec:
                state, metrics = step(state, batch)
            if i == 0:
                coll = rec.summary()
            losses.append(float(metrics["loss"]))
        return losses, state, coll, step

    def slices(tree, plan, spec_of):
        return {k: shard_leaf(t, plan, spec_of[k], plan.mesh.coords) for k, t in tree.items()}

    ref = {}
    for r in range(MR_RANKS):  # one rank at a time: an AdamW state of the whole model each
        if rank == r:
            with gemm_context(backend="cuda"):
                params = params_for()
                loss, _ = model.loss_fn(params, batch0)
                loss.backward()
                ref["loss"] = loss.item()
                ref["grads"] = slices(dict(tree_items(take_grads(params))), plans["1x2"], specs)
                del params, loss
                ref["adamw"] = steps("adamw", 2, batch0)[0]
                ref["adafactor"], state, _, _ = steps("adafactor", 2, batch0)
                leaves = _opt_leaves(state["opt"], specs)
                spec_of = {k: s for k, (_, s) in leaves.items()}
                full = {k: t for k, (t, _) in leaves.items()}
                ref["opt"] = {name: slices(full, plan, spec_of) for name, plan in plans.items()}
                del state, leaves, full
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()

    out = {}
    sp = plans["1x2"]
    with use_plan(sp), gemm_context(backend="cuda"):
        batch = local_rows(batch0)
        if not model.sequence_parallel(batch["tokens"].shape):
            raise RuntimeError(f"phase 13 (c): {tuple(batch['tokens'].shape)} is not split "
                               "along its positions under seq = 'model'")
        reads = {}
        for fault in (False, True):
            params = params_for()
            reset_launch_counts()
            with wrong_slice_scatter(rank) if fault else nullcontext():
                loss, _ = model.loss_fn(params, batch)
                loss.backward()
                grads = sync_grads(take_grads(params), model.param_specs(), sp,
                                   model.seq_parallel_leaves(batch))
            torch.cuda.synchronize()
            if not fault:
                out["launches"] = _mr_launches()
            reads[fault] = (abs(loss.item() - ref["loss"]) / abs(ref["loss"]),
                            _shard_diff(dict(tree_items(grads)), ref["grads"], sp, specs))
            del params, grads, loss
        (out["loss_rel"], out["grad_rel"]), (out["fault_loss_rel"], out["fault_rel"]) = (
            reads[False], reads[True])
        losses, state, out["collectives"], step = steps("adamw", 2, batch)
        out["adamw_loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["adamw"]))
        out["split"] = mr_decode_split(rank, lambda: step(state, batch), iters=1)
        del state, step
    for name, plan in plans.items():
        gc.collect()
        torch.cuda.empty_cache()
        with use_plan(plan), gemm_context(backend="cuda"):
            losses, state, _, _ = steps("adafactor", 2, local_rows(batch0))
            mine = _opt_leaves(state["opt"], specs)
            read = {}
            for group in ("v/", "master/"):
                part = {k: v for k, v in mine.items() if k.startswith(group)}
                read[group] = _shard_diff({k: t for k, (t, _) in part.items()},
                                          ref["opt"][name], plan,
                                          {k: s for k, (_, s) in part.items()})
            out[f"adafactor_{name}"] = dict(
                loss_rel=max(abs(a - b) / abs(b) for a, b in zip(losses, ref["adafactor"])),
                moments_rel=read["v/"], masters_rel=read["master/"])
            del state, mine
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 13 (c) on rank {rank}: {out['seconds']:.1f}s")
    return out


def phase13_cells():
    """The dry run's cells of phase 13, each as its parts run it: (name, arch, shape,
    mesh, rules, config overrides, shape overrides)."""
    return (("decode", "granite-8b", "decode_32k", (1, MR_RANKS), dict(MR13_RULES),
             {"n_layers": MR13_LAYERS}, {"global_batch": len(MR13_PROMPTS),
                                         "seq_len": MR13_SEQ}),
            ("long", "zamba2-1.2b", "long_500k", (MR_RANKS, 1), None,
             {"n_layers": MR13_ZAMBA_LAYERS}, {"global_batch": 1, "seq_len": MR13_LONG_SEQ}),
            ("train", "granite-8b", "train_4k", (1, MR_RANKS), None,
             {"n_layers": MR13_TRAIN_LAYERS}, {"global_batch": MR13_TRAIN_ROWS,
                                                "seq_len": MR13_TRAIN_SEQ}))


def phase13_dryrun(path):
    """The dry run's record of each of ``phase13_cells()`` (run in phase 9 (a)'s child
    process, no card), to ``path``."""
    from repro_torch.launch.dryrun import lower_cell

    out = {}
    for name, arch, shape, mesh, rules, over, shape_over in phase13_cells():
        try:
            art = lower_cell(arch, shape, False, extra_rules=rules, mesh_shape=mesh,
                             config_overrides=over, shape_overrides=shape_over)
        except Exception as e:  # reported in phase 13: the ranks' record has no match
            art = dict(collectives=None, config={"rules": None},
                       status=f"error: {type(e).__name__}: {e}"[:2000])
        out[name] = dict(collectives=art["collectives"], rules=art["config"]["rules"],
                         status=art["status"])
    Path(path).write_text(json.dumps(out))


def phase_production_rules(rank_outs, dry, failures):
    """Phase 13: repro's production rules across two ranks on the one card over gloo (the
    rank parts ran in the background rank program; ``dry``: phase 9 (a)'s child and its
    artifacts' path, whose phase 13 cells sit beside them). (a) granite-8b decode under
    kv_seq over model, (b) zamba2-1.2b under long_500k's kv_seq over data, (c) granite-8b
    trained sequence-parallel, then Adafactor: each reading at its limit, each planted
    fault at least 3 times it, each step's collectives equal to the dry run's op by op,
    B1 or B2 launched on each rank."""
    t0 = time.perf_counter()
    rec = {}
    if rank_outs is None:
        failures.append("phase 13: the rank program gave no output")
        return rec
    path = Path(str(dry[1])).with_name("phase13_dryrun.json") if dry else None
    arts = json.loads(path.read_text()) if path is not None and path.exists() else None
    if arts is None:
        failures.append("phase 13: the dry run's cells were not traced")
        arts = {}
    tol = LOGITS_TOL["granite-8b"]
    for part, key in (("decode", "mr13_decode"), ("long", "mr13_long"), ("train", "mr13_train")):
        outs = [r.get(key) for r in rank_outs]
        if None in outs:
            failures.append(f"phase 13 {part}: a rank gave no output")
            continue
        g = outs[0]
        what = {"decode": f"phase 13 (a) granite-8b x {MR13_LAYERS} decode, kv_seq over "
                          f"(pod, data, model) on (1, {MR_RANKS})",
                "long": f"phase 13 (b) zamba2-1.2b x {MR13_ZAMBA_LAYERS}, long_500k's rule on "
                        f"({MR_RANKS}, 1)",
                "train": f"phase 13 (c) granite-8b x {MR13_TRAIN_LAYERS} trained, seq on model "
                         f"(1, {MR_RANKS})"}[part]
        r = dict(seconds=[o["seconds"] for o in outs], split=[o["split"] for o in outs],
                 launches=[o["launches"] for o in outs], collectives=g["collectives"])
        if part == "decode":
            r["prefill_rel"] = _read(g["prefill_rel"], tol, f"{what} prefill logits", failures)
            r["decode_rel"] = _read(g["decode_rel"], tol, f"{what} decode logits", failures)
            r["fault_rel"] = _planted(g["fault_rel"], tol, f"{what} (rank 1's partial dropped "
                                      "from the combine)", failures)
            r["cache_shapes"] = [o["cache_shapes"] for o in outs]
        elif part == "long":
            r["prefill_layers"], r["decode_layers"] = g["prefill_layers"], g["decode_layers"]
            r["fault_layers"] = g["fault_layers"]
            r["prefill_rel"] = _read(max(g["prefill_layers"]), tol, f"{what} prefill logits, "
                                     "each layer fed the ranks' input", failures)
            r["decode_rel"] = _read(max(g["decode_layers"]), tol, f"{what} decode logits, each "
                                    "layer fed the ranks' input and cache", failures)
            r["decode_attn"], r["fault_attn"] = g["decode_attn"], g["fault_attn"]
            r["attn_rel"] = _read(max(g["decode_attn"]), tol, f"{what} decode step's attention "
                                  "calls, each fed the ranks' input and the cache", failures)
            r["fault_rel"] = _planted(max(g["fault_attn"]), tol, f"{what} decode step's attention "
                                      "(rank 1's partial dropped from the combine)", failures)
            r["fault_layers_rel"] = max(g["fault_layers"])
            r["prefill_e2e_rel"], r["decode_e2e_rel"] = g["prefill_e2e"], g["decode_e2e"]
            r["cache_shapes"], r["rules"] = [o["cache_shapes"] for o in outs], g["rules"]
        else:
            r["loss_rel"] = _read(g["loss_rel"], TRAIN_LOSS_TOL, f"{what} loss", failures)
            r["grad_rel"] = _read(g["grad_rel"], TRAIN_GRAD_TOL, f"{what} gradients",
                                  failures)
            r["fault_rel"] = _planted(g["fault_rel"], TRAIN_GRAD_TOL, f"{what} gradients (rank "
                                      "1's reduce-scatters keep the neighbour's slice)",
                                      failures)
            r["fault_loss_rel"] = g["fault_loss_rel"]
            r["adamw_loss_rel"] = _read(g["adamw_loss_rel"], TRAIN_LOSS_TOL,
                                        f"{what} AdamW losses", failures)
            for mesh in ("1x2", "2x1"):
                a = g[f"adafactor_{mesh}"]
                r[f"adafactor_{mesh}"] = a
                _read(a["loss_rel"], TRAIN_LOSS_TOL, f"{what}: Adafactor on {mesh} losses",
                      failures)
                _read(a["moments_rel"], TRAIN_GRAD_TOL, f"{what}: Adafactor on {mesh} "
                      "factored moments", failures)
                _read(a["masters_rel"], TRAIN_GRAD_TOL, f"{what}: Adafactor on {mesh} masters",
                      failures)
        art = arts.get(part)
        want = None if art is None else art["collectives"]
        same = [o["collectives"] == want for o in outs]
        r["dryrun_collectives"], r["same_collectives"] = want, same
        if not all(same):
            failures.append(f"{what}: a step's collectives {[o['collectives'] for o in outs]} vs "
                            f"the dry run's {want}")
        planted = json.loads(json.dumps(want or {}))
        if planted.get("all-reduce"):
            planted["all-reduce"]["count"] += 1
        if any(o["collectives"] == planted for o in outs):
            failures.append(f"{what}: the planted extra all-reduce went unseen")
        by_rank = [{k: o["launches"].get(k, 0) for k in ("dp_gemm_region", "streamk_phase1")}
                   for o in outs]
        for rk, by in enumerate(by_rank):
            if not any(by.values()):
                failures.append(f"{what}: neither B1 nor B2 launched on rank {rk}")
        rec[part] = r
        lists = ("launches", "split", "dryrun_collectives", "prefill_layers", "decode_layers",
                 "fault_layers", "decode_attn", "fault_attn")
        shown = {k: v for k, v in r.items() if k not in lists}
        log(f"{what}: {json.dumps(shown)}; B1/B2 launches by rank {by_rank}; a warm step by "
            f"rank {r['split']}")
    rec["seconds"] = time.perf_counter() - t0
    log(f"phase 13 (repro's production rules across ranks, two processes on one card over "
        f"gloo): {rec['seconds']:.1f}s here")
    return rec


def production13_launches(rec):
    """Phase 13's launches by part, each a list of the ranks' counters."""
    return {f"prod13_{part}": rec[part]["launches"] for part in ("decode", "long", "train")
            if isinstance(rec.get(part), dict)}


# ---------------------------------------------------------------------------
# Phase 14: the compiled decode step
# ---------------------------------------------------------------------------


def _tap_logits(engine):
    """Keep each decode step's logits (f32, on the host) as ``engine``'s
    compiled step returns them, replays and warm-ups alike; returns the list
    they go to. The step's own path is left as it is (a subclass's call runs
    it first)."""
    from repro_torch.serve.graphs import DecodeStep

    class Tapped(DecodeStep):
        def __call__(self, key, **inputs):
            out = super().__call__(key, **inputs)
            self.logits.append(out.float().cpu())
            return out

    engine.decode.__class__ = Tapped
    engine.decode.logits = []
    return engine.decode.logits


def b5_called_for(engine, label):
    """The B5 launches a served run's grouped dispatches call for, through
    the replay accounting: each grouped dispatch that ran eagerly (a
    prefill, a decode step's warm-up) once, each captured step's B5
    launches once per replay. Raises where a capture lists other B5
    launches than its grouped dispatches."""
    step = engine.decode
    at_capture = {id(e) for c in step.captured for e in c.selections}
    total = sum(1 for e in engine.selection_log if e.op.fused and id(e) not in at_capture)
    for c in step.captured:
        b5 = sum(1 for name in c.launches if name.startswith("grouped_streamk"))
        grouped = sum(1 for e in c.selections if e.op.fused)
        if b5 != grouped:
            raise AssertionError(f"{label}: a captured decode step lists {b5} B5 launches for "
                                 f"{grouped} grouped dispatches")
        total += b5 * c.replays
    return total


def graph_vs_eager(label, engine, tokens, make_engine, prompts, tol, failures, new=8,
                   breakdown=False):
    """Phase 14: ``engine``'s served run (on the card, by graph replay; its
    logits tapped by ``_tap_logits`` before it ran, ``tokens`` its greedy
    tokens by request) against the same requests through ``make_engine()``
    under ``disable_graphs()``: the mode must have been "graph" there and
    "eager" here, the tokens equal, and each decode step's logits within
    ``tol`` x max|logit| (the same kernels on the same inputs: 0 expected).
    With ``breakdown``, a warm replayed step's split (``decode_breakdown``
    of the compiled step's call: inputs copied in, the graph replayed).
    Returns the record."""
    import torch

    from repro_torch.serve.graphs import DecodeStep, disable_graphs

    t0 = time.perf_counter()
    step = engine.decode
    # the mode, captures and replays, each capture's seconds (warm-up included) and pool
    rec = dict(step_mode=step.mode, captures=len(step.captured), replays=step.replays,
               keys=[list(c.key) for c in step.captured],
               capture_s=[c.seconds for c in step.captured],
               pool_bytes=[c.pool_bytes for c in step.captured])
    with disable_graphs():
        eager = make_engine()
        eager_mode = eager.step_mode
        logits = _tap_logits(eager)
        for p in prompts:
            eager.submit(p, max_new_tokens=new)
        done = eager.run()
    torch.cuda.synchronize()
    want = {r.uid: r.out_tokens for r in done}
    diffs = [(g - e).abs().max().item() for g, e in zip(step.logits, logits)]
    scale = max((e.abs().max().item() for e in logits), default=0.0)
    worst = max(diffs, default=math.inf)
    if rec["step_mode"] != "graph" or not rec["captures"] or not rec["replays"]:
        failures.append(f"{label}: the served run was not replayed: {rec}")
    if eager_mode != "eager" or eager.decode.captured:
        failures.append(f"{label}: disable_graphs() left the step in mode {eager_mode}")
    if tokens != want:
        failures.append(f"{label}: graph-replayed greedy tokens {tokens} vs eager {want}")
    if len(diffs) != len(logits) or len(diffs) != len(step.logits) or not worst <= tol * scale:
        failures.append(f"{label}: graph vs eager decode logits max|diff| {worst:.4g} over "
                        f"{len(diffs)} steps (eager {len(logits)}) > {tol} * {scale:.4f}")
    tm_g, tm_e = engine.timing, eager.timing
    rec.update(eager_step_mode=eager_mode, tokens_equal=tokens == want, step_diffs=diffs,
               max_abs_diff=worst, max_abs_logit=scale, tol=tol,
               decode_step_ms=tm_g["decode_s"] / max(tm_g["decode_steps"], 1) * 1e3,
               eager_decode_step_ms=tm_e["decode_s"] / max(tm_e["decode_steps"], 1) * 1e3)
    del eager, logits
    if breakdown:
        live = step.captured[-1]
        bufs = next(iter(step.buffers.values()))
        inputs = {name: b.cpu().numpy() for name, b in bufs.items()}
        rec["breakdown"] = decode_breakdown(
            lambda: DecodeStep.__call__(step, live.key[0], **inputs))
    rec["seconds"] = time.perf_counter() - t0
    log(f"{label}: graph vs eager: tokens equal {rec['tokens_equal']}, decode logits max|diff| "
        f"{worst:.4g} over {len(diffs)} steps (limit {tol * scale:.4f}); {rec['captures']} "
        f"capture(s) ({', '.join(f'{s:.2f}' for s in rec['capture_s'])} s; pool "
        f"{[round(b / 2**20, 1) for b in rec['pool_bytes']]} MiB), {rec['replays']} replays; "
        f"wall ms a decode step {rec['decode_step_ms']:.2f} graph, "
        f"{rec['eager_decode_step_ms']:.2f} eager")
    return rec


def graph_faults(model, params, failures):
    """Phase 14 (e) on phase 3's granite-8b bf16 weights: two planted faults
    of the compiled step, each against the eager run of the same requests,
    each of which must change the greedy tokens or read at least 3 times
    ``LOGITS_TOL``: a replay that skips refreshing the token buffer, and a
    captured step whose cache writes go to a copy (made inside the capture,
    so every replay copies the cache and writes its row into the copy)."""
    import torch

    from repro_torch.kernels import common
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.graphs import DecodeStep, disable_graphs

    prompts = serve_prompts(model.cfg.vocab_size)
    tol = LOGITS_TOL["granite-8b"]

    def serve(plant=None):
        eng = ServeEngine(model, params, ServeConfig(n_slots=N_SLOTS, max_seq=MAX_SEQ, eos=-1),
                          backend="cuda")
        logits = _tap_logits(eng)
        if plant is not None:
            plant(eng)
        for p in prompts:
            eng.submit(p, max_new_tokens=8)
        done = eng.run()
        torch.cuda.synchronize()
        return {r.uid: r.out_tokens for r in done}, logits, eng

    def stale_tokens(eng):
        step = eng.decode

        def copy_in(name, buf, a):
            if not (name == "tokens" and step.captured):
                DecodeStep.copy_in(step, name, buf, a)

        step.copy_in = copy_in

    def cache_copy(eng):
        step = eng.decode
        real = step.fn

        def fn(bufs):
            if common._capture is None:
                return real(bufs)
            cache = eng.cache
            eng.cache = _clone_tree(cache)
            try:
                return real(bufs)
            finally:
                eng.cache = cache

        step.fn = fn

    with disable_graphs():
        want, want_logits, _ = serve()
    scale = max(e.abs().max().item() for e in want_logits)
    out = {}
    for name, plant in (("stale_tokens", stale_tokens), ("cache_copy", cache_copy)):
        got, logits, eng = serve(plant)
        diff = max(((g - e).abs().max().item() for g, e in zip(logits, want_logits)),
                   default=0.0)
        caught = got != want or diff >= 3 * tol * scale
        out[name] = dict(tokens_changed=got != want, max_abs_diff=diff, limit=tol * scale,
                         caught=caught, replays=eng.decode.replays)
        del eng
        log(f"phase 14 (e) planted fault {name}: tokens changed {got != want}, decode logits "
            f"max|diff| {diff:.4f} (3x the limit {3 * tol * scale:.4f})")
        if not caught:
            failures.append(f"phase 14 (e): the planted fault {name} went unseen (tokens equal, "
                            f"max|diff| {diff:.4f} < 3 * {tol} * {scale:.4f})")
    return out


#: phase 14 (d): tokens a request, so that the last steps replay once the rounds have tuned
#: every fingerprint (one round a step, 4 fingerprints a round)
ADAPT_NEW = 16


def adapt_graph_check(model, params, failures):
    """Phase 14 (d) on phase 4's granite-8b weights: an engine with an
    ``AdaptiveTuner`` as phase 4's (``hot_threshold=1``, a round every
    engine step, the top-5 budget), tuning from an empty database, against
    its eager twin. The tuner is the analytical model (on the H100's nominal
    machine), so both runs commit the same records at the same steps: the
    graph engine must capture anew after a hot swap, and its tokens and
    logits must be the twin's."""
    from repro_torch.core import costmodel
    from repro_torch.core.adaptive import AdaptiveConfig, AdaptiveTuner
    from repro_torch.core.policies import HOPPER_TILE_CONFIGS
    from repro_torch.core.selector import KernelSelector, SelectorState
    from repro_torch.core.tuner import Tuner, TuningDatabase
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    def make():
        db = TuningDatabase()
        sel = KernelSelector(mach=costmodel.H100, tile_configs=HOPPER_TILE_CONFIGS,
                             state=SelectorState(db=db, sieve=db.build_sieve()))
        tuner = Tuner(policies=sel.policies, tile_configs=sel.tile_configs, mach=costmodel.H100,
                      grid_sizes=sel.grid_sizes, top_k=TUNE_TOP_K)
        ad = AdaptiveTuner(sel, tuner=tuner,
                           config=AdaptiveConfig(hot_threshold=1, top_k=TUNE_TOP_K))
        return ServeEngine(model, params, ServeConfig(n_slots=N_SLOTS, max_seq=MAX_SEQ, eos=-1),
                           backend="cuda", selector=sel, adaptive=ad, adapt_every=1)

    prompts = serve_prompts(model.cfg.vocab_size)
    eng = make()
    _tap_logits(eng)
    for p in prompts:
        eng.submit(p, max_new_tokens=ADAPT_NEW)
    tokens = {r.uid: r.out_tokens for r in eng.run()}
    rec = graph_vs_eager("phase 14 (d) granite-8b adapting online", eng, tokens, make, prompts,
                         LOGITS_TOL["granite-8b"], failures, new=ADAPT_NEW)
    swaps = sorted({key[1] for key in rec["keys"]})
    rec.update(adaptations=eng.adaptive.stats.adaptations, swaps=eng.selector.swaps,
               capture_swaps=swaps)
    if not eng.adaptive.stats.adaptations or len(swaps) < 2:
        failures.append(f"phase 14 (d): {eng.adaptive.stats.adaptations} adaptations, captures "
                        f"under swap counts {swaps}: no capture followed a hot swap")
    log(f"phase 14 (d): {rec['adaptations']} adaptations, {rec['swaps']} hot swaps, captures "
        f"under swap counts {swaps}")
    return rec


def eager_across_ranks(what, records, failures):
    """Phase 14 (f): every ``step_mode`` in ``records`` (rank parts'
    outputs, the serve CLI's worker summaries, nested anywhere) must read
    "eager": across ranks the decode step is not captured. Returns the
    modes."""
    modes = []

    def walk(node):
        if isinstance(node, dict):
            for key, val in node.items():
                if key == "step_mode":
                    modes.append(val)
                else:
                    walk(val)
        elif isinstance(node, (list, tuple)):
            for val in node:
                walk(val)

    walk(records)
    if not modes or set(modes) != {"eager"}:
        failures.append(f"{what}: the decode step's modes across ranks are {modes}, not eager")
    return modes


def phase_compiled(serve, paged, tune, archs, families, ranked, failures):
    """Phase 14's record, gathered from the runs of phases 3-13 that hold
    its parts (see the module docstring): (a) granite-8b and olmoe-1b-7b
    dense and on every rung, (b) the paged engine, (c) phases 6's and 7's
    engines, (d) the adapting engine, (e) the planted faults, (f) the modes
    across ranks; the seconds it added."""
    rec = dict(a={f"{arch} {rung}": run["compiled"] for arch, runs in serve.items()
                  for rung, run in runs.items()},
               b={**{run: paged["granite"][run]["compiled"] for run in ("whole", "chunked")},
                  "olmoe": paged["olmoe"]["run"]["compiled"]},
               c={arch: run["compiled"] for arch, run in {**archs, **families}.items()
                  if "compiled" in run},
               d=tune["compiled"], e=serve["granite-8b"]["dense"]["faults14"], f=ranked)
    parts = [*rec["a"].values(), *rec["b"].values(), *rec["c"].values(), rec["d"]]
    rec["tokens_equal"] = all(p["tokens_equal"] for p in parts)
    rec["max_abs_diff"] = max(p["max_abs_diff"] for p in parts)
    rec["seconds"] = sum(p["seconds"] for p in parts)
    for label, r in rec["a"].items():
        bd, eager = r["breakdown"], serve[label.split()[0]][label.split()[1]]["decode_breakdown"]
        log(f"phase 14 (a) {label} warm decode step: replayed {bd['step_ms']:.2f} ms wall, "
            f"device busy {bd['device_busy_ms']} ms (GEMM kernels {bd['gemm_kernels_ms']}), "
            f"idle share {bd['idle_share']}; eager {eager['cuda']['step_ms']:.2f} ms wall, "
            f"device busy {eager['cuda']['device_busy_ms']}, idle share "
            f"{eager['cuda']['idle_share']}; capture {r['capture_s']} s, pool "
            f"{r['pool_bytes']} bytes")
    log(f"phase 14 (the compiled decode step): {len(parts)} runs against eager, tokens equal "
        f"{rec['tokens_equal']}, logits max|diff| {rec['max_abs_diff']:.4g}; planted faults "
        f"{ {k: v['caught'] for k, v in rec['e'].items()} }; modes across ranks "
        f"{sorted(set(sum(ranked.values(), [])))}; {rec['seconds']:.1f}s of the run")
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the H100", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--multirank"]:
        return multirank_main(sys.argv[2])
    if sys.argv[1:2] == ["--background-ranks"]:
        return background_ranks_main(sys.argv[2])
    import shutil
    import signal

    dry = []  # phase 9 (a)'s child process and its artifacts' path, once started
    jobs = []  # the background rank parts' job, once started
    try:
        return run_phases(dry, jobs)
    finally:
        if dry and dry[0].poll() is None:
            dry[0].kill()
        if dry:
            dry[0].wait()
        for job in jobs:
            if job["proc"].poll() is None:
                os.killpg(job["proc"].pid, signal.SIGKILL)
                job["proc"].wait()
            shutil.rmtree(job["dir"], ignore_errors=True)


def run_phases(dry, jobs) -> int:
    import torch

    from repro_torch.configs import get_config

    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_s = {}  # each phase's seconds, in the order they ran
    last = [t_start]

    def mark(name):
        now = time.perf_counter()
        phase_s[name] = round(now - last[0], 1)
        last[0] = now

    smi, build_s = phase_device()
    mark("1 device and build")
    # phase 9 (a)'s traces need no card: they run beside phases 2-8, after the build (whose
    # nvcc processes take every core)
    dry.extend(start_dryrun())

    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    errs, cases = sweep(gen)
    log(f"sweep {SWEEP_SHAPES}: {cases} cases agree; max errors {errs} "
        f"({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    slice_err, picks = slice_shapes(gen, "granite-8b", GRANITE_NK)
    olmoe_err, olmoe_picks = slice_shapes(gen, "olmoe-1b-7b", OLMOE_NK)
    slice_err, picks = max(slice_err, olmoe_err), picks + olmoe_picks
    for arch in [a for a, _ in ARCH_CELLS + FAMILY_CELLS]:
        # phase 6's and 7's models at the decode batch and M = 64 (whisper also at its
        # 1500 frames, the M of a request's cross K/V projections)
        ms = (N_SLOTS, 64, 1500) if arch == "whisper-large-v3" else (N_SLOTS, 64)
        arch_err, arch_picks = slice_shapes(gen, arch, arch_nk(get_config(arch)), ms=ms)
        slice_err, picks = max(slice_err, arch_err), picks + arch_picks
        gc.collect()
        torch.cuda.empty_cache()
    log(f"slice shapes: {len(picks)} shapes (granite-8b, olmoe-1b-7b, phase 6's "
        f"{[a for a, _ in ARCH_CELLS]} and phase 7's {[a for a, _ in FAMILY_CELLS]}) x (pick, dp, all_sk) "
        f"agree with gemm_ref, max err "
        f"{slice_err:.3e}; B2+B3 bitwise deterministic ({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    b5_errs, b5_cases, b5_bitwise = sweep_grouped(gen)
    errs.update(b5_errs)
    log(f"B5 sweep {GROUPED_SHAPES + (GROUPED_RAGGED,)}: {b5_cases} cases agree with the plain "
        f"version and gemm_ref; max errors {b5_errs}; {b5_bitwise} split-tile cases bitwise "
        f"deterministic; all-empty launches nothing ({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    q_errs, q_cases, q_bitwise = quant_sweep(gen)
    log(f"quantized sweep {QUANT_SWEEP_SHAPES} x {[p[0] for p in QUANT_PAIRS]}: {q_cases} cases "
        f"agree with the plain versions and dequantize-then-matmul; max errors {q_errs}; "
        f"{q_bitwise} B2+B3 bitwise repeats ({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    qg_errs, qg_cases, qg_bitwise = quant_sweep_grouped(gen)
    log(f"quantized B5 sweep {QUANT_GROUPED_SHAPES}: {qg_cases} cases agree with the plain "
        f"version and dequantize-then-matmul; max errors {qg_errs}; {qg_bitwise} split-tile "
        f"cases bitwise deterministic ({time.perf_counter() - t0:.1f}s)")
    timed = time_kernels(gen)
    log("main-path GEMMs, decode (M=4) and prompt (M=64):")
    gemms = time_main_path_gemms(gen, 4) + time_main_path_gemms(gen, 64)
    log("B5 at olmoe-1b-7b's expert shapes:")
    grouped_rows = time_grouped(gen)
    for name in ("grouped_streamk_sk", "grouped_streamk_dp"):
        timed[name] = grouped_entry(grouped_rows, name)
    log("the quantized kernels at the decode and prompt shapes of each rung:")
    t0 = time.perf_counter()
    quant_rows = time_quant(gen)
    log(f"quantized timings ({time.perf_counter() - t0:.1f}s)")
    b5_rows = b5_table(grouped_rows, quant_rows)
    b5_s8_rows = b5_s8_table(quant_rows)
    b12_rows = b12_table(timed, quant_rows)
    b12_s8_rows = b12_s8_table(quant_rows)
    f32_rows = f32_table(gen)
    t0 = time.perf_counter()
    sk_errs, sk_cases, sk_bitwise, sk_empty, sk_fault, sk_launches = splitk_sweep(gen)
    log(f"B6 sweep {SPLITK_SHAPES} x {[p[0] for p in SPLITK_PAIRS]} x s {SPLITK_S} x g "
        f"{SPLITK_G}: {sk_cases} cases agree with the plain version and the reference; max "
        f"errors {sk_errs}; {sk_bitwise} bitwise repeats; {sk_empty} cases with empty splits "
        f"read 0; planted fault {sk_fault}; launches by pair {sk_launches} "
        f"({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    log("the baseline comparison at granite-8b's projections (device ms):")
    compare_rows, compare_launches, compare_err = baseline_comparison(gen)
    log("B6 at 4x14336x4096, s = 4, on every operand pair (device ms):")
    splitk_rows = time_splitk(gen)
    timed["splitk_partials"] = next(r for r in splitk_rows if r["pair"] == "bf16")
    batched = batched_check(gen)
    log(f"baseline comparison, B6 timing and gemm_batched ({time.perf_counter() - t0:.1f}s)")
    gc.collect()
    torch.cuda.empty_cache()

    mark("2 kernels")
    failures = []
    t0 = time.perf_counter()
    paged = {}  # phase 5 (a) runs on phase 3's granite-8b weights, before they are freed

    def paged_granite(model, params, runs):
        runs["dense"]["faults14"] = graph_faults(model, params, failures)  # phase 14 (e)
        paged["granite"] = phase_paged_granite(model, params, runs, failures)

    serve = {"granite-8b": phase_serve("granite-8b", failures, then=paged_granite)}
    log(f"granite-8b served dense and on {list(RUNGS)} ({time.perf_counter() - t0:.1f}s)")
    mark("3 granite-8b and 5 (a)")
    gc.collect()  # granite's weights go before the next model's arrive
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kv_int8 = phase_kv_int8()
    log(f"int8 KV cache phase ({time.perf_counter() - t0:.1f}s)")
    mark("3 int8 KV cache")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    moe_variants = {}  # phase 9 (c) runs on phase 3's olmoe-1b-7b weights, before they are freed

    def olmoe_variants(model, params, runs):
        moe_variants.update(phase_moe_variants(model, params, failures))

    serve["olmoe-1b-7b"] = phase_serve("olmoe-1b-7b", failures, then=olmoe_variants)
    log(f"olmoe-1b-7b served dense and on {list(RUNGS)} ({time.perf_counter() - t0:.1f}s)")
    mark("3 olmoe-1b-7b and 9 (c)")
    gc.collect()
    torch.cuda.empty_cache()
    tune = phase_tune(failures)
    mark("4 tune")
    gc.collect()
    torch.cuda.empty_cache()
    # phases 10 (c), 11, 12 and 13 on the ranks, from here on beside phases 5-9
    jobs.append(start_background_ranks())
    paged = phase_paged(paged["granite"], failures)
    mark("5 paged")
    gc.collect()
    torch.cuda.empty_cache()
    archs = phase_archs(failures)
    mark("6 archs")
    gc.collect()
    torch.cuda.empty_cache()
    families = phase_families(failures)
    mark("7 families")
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train(failures)
    mark("8 train")
    gc.collect()
    torch.cuda.empty_cache()
    shard = phase_shard(dry, moe_variants, gen, failures)
    mark("9 shard")
    shard_launches = (shard["shard_gemms"] or {}).get("launches", {})
    gc.collect()
    torch.cuda.empty_cache()
    # phase 10 (a)'s and 12 (a)'s serve CLIs at once (granite-8b's, 16 GB, beside mamba2-1.3b's:
    # with phase 11 (a)'s two quantized granite-8b runs besides, eight ranks ran out of the
    # card's 80 GB); phase 11 (a)'s two, at once, after the rank program
    clis = rank_clis(("granite-8b", "mamba2-1.3b"))
    multirank = phase_multirank(clis["granite-8b"],
                                (shard["mesh_model_cli"] or {}).get("tokens"),
                                tune.pop("sieve", None), tune.pop("winners", None), jobs[0],
                                failures)
    mr_launches = multirank_launches(multirank)
    mark("10 ranks (with 12 (a)'s CLI)")
    gc.collect()
    torch.cuda.empty_cache()
    rank_outs = multirank.pop("rank_outs")
    clis.update(rank_clis(MR11_RUNGS))
    serve11 = phase_serve_ranks(rank_outs, clis, failures)
    s11_launches = serve11_launches(serve11)
    mark("11 serve ranks")
    gc.collect()
    torch.cuda.empty_cache()
    families12 = phase_families_ranks(rank_outs, clis["mamba2-1.3b"], failures)
    mark("12 families ranks")
    s11_launches.update({f"fam12_{run}": ranks
                         for run, ranks in families12_launches(families12).items()})
    production13 = phase_production_rules(rank_outs, dry, failures)
    mark("13 production rules")
    # phase 14 (f): across ranks every engine and plan decodes eagerly
    bg = [o or {} for o in rank_outs]
    ranked = {
        "10": eager_across_ranks("phase 10", [clis["granite-8b"][3], [
            {"step_mode": m} for m in (multirank.get("ranks") or {}).get("step_modes", [])]],
                                 failures),
        "11": eager_across_ranks("phase 11", [[clis[r][3] for r in MR11_RUNGS],
                                              [o.get("serve11_data") for o in bg],
                                              [o.get("serve11_paged") for o in bg]], failures),
        "12": eager_across_ranks("phase 12", [clis["mamba2-1.3b"][3],
                                              [o.get(f"fam12_{a}") for o in bg
                                               for a, _ in MR12_CELLS]], failures),
        "13": eager_across_ranks("phase 13", [o.get("mr13_decode") for o in bg], failures),
    }
    del rank_outs, bg
    compiled = phase_compiled(serve, paged, tune, archs, families, ranked, failures)
    mark("14 compiled (its runs inside phases 3-7)")
    s11_launches.update(production13_launches(production13))

    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.common import mainloop

    kernels = []
    for name in SERVED_KERNELS:
        t = timed[name]
        # launches: each kernel's count from the main path that serves it
        arch = "olmoe-1b-7b" if name.startswith("grouped") else "granite-8b"
        other = "granite-8b" if arch != "granite-8b" else "olmoe-1b-7b"
        extra = {key: t[key] for key in ("sweep_shape", "sweep_ms", "sweep_plain_ms",
                                         "library_of", "composed_ms") if key in t}
        # the served models and the timings run bf16 activations
        extra["mainloop"] = mainloop(name, torch.bfloat16)
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=serve[arch]["dense"]["launches"].get(name, 0),
            max_abs_err=t["max_abs_err"], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], shape=t["shape"], policy=t["policy"], tile=t["tile"],
            g=t["g"], sweep_max_err=errs[name], event_ms=t["event_ms"],
            plain_event_ms=t["plain_event_ms"], library_event_ms=t.get("library_event_ms"),
            launches_in=arch, launches_other_model=serve[other]["dense"]["launches"].get(name, 0),
            # phase 8's main path: Trainer.fit's launches, by trained model
            train_launches={a: train[a]["fit_launches"].get(name, 0) for a in train},
            # phase 9's: the per-shard GEMMs, and olmoe on the MoE variants
            shard_gemm_launches=shard_launches.get(name, 0),
            moe_variant_launches={impl: moe_variants[impl]["launches"].get(name, 0)
                                  for impl, _ in MOE_VARIANTS},
            # phase 10's and 11's: each rank's launches across ranks, by run
            multirank_launches={run: [by.get(name, 0) for by in ranks]
                                for run, ranks in {**mr_launches, **s11_launches}.items()},
            **extra,
        ))
    # B6 has no served caller: its launches are those of the baseline comparison, the
    # slice's main path
    t = timed["splitk_partials"]
    kernels.append(dict(
        name="splitk_partials", route="cuda", source=SOURCES["splitk_partials"],
        replaces=REPLACES["splitk_partials"], launches=compare_launches["splitk_partials"],
        max_abs_err=t["max_abs_err"], ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=t["library_ms"], library_of=t["library_of"],
        shape=t["shape"], policy=t["policy"], tile=t["tile"], g=t["g"],
        sweep_max_err=max(v for key, v in sk_errs.items() if key.startswith("splitk_partials")),
        event_ms=t["event_ms"], plain_event_ms=t["plain_event_ms"],
        library_event_ms=t["library_event_ms"], launches_in="the baseline comparison",
        mainloop=t["mainloop"],
    ))
    not_served = []
    for rung, (_, _, pair_source) in RUNGS.items():
        for name in SERVED_KERNELS:
            key = f"{name}[{rung}]"
            # each (kernel, rung) that a served path ran: its count from the model that
            # serves it (granite-8b for B1 and B2, olmoe-1b-7b for B5), else from the other
            arch = "olmoe-1b-7b" if name.startswith("grouped") else "granite-8b"
            other = "granite-8b" if arch != "granite-8b" else "olmoe-1b-7b"
            counts = {a: serve[a][rung]["launches"].get(key, 0) for a in (arch, other)}
            if not counts[arch]:
                arch, other = other, arch
            if not counts[arch]:
                not_served.append(key)
                continue
            t = quant_entry(quant_rows, name, rung)
            kernels.append(dict(
                name=key, route="cuda", source=SOURCES[name], instantiated_in=pair_source,
                replaces=REPLACES[name], launches=counts[arch],
                max_abs_err=t["max_abs_err"], ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=t["library_ms"],
                library_of=t["library_of"], shape=t["shape"], policy=t["policy"],
                tile=t["tile"], g=t["g"], event_ms=t["event_ms"],
                plain_event_ms=t["plain_event_ms"], library_event_ms=t["library_event_ms"],
                launches_in=f"{arch} {rung}", launches_other_model=counts[other],
                mainloop=mainloop(name, torch.int8 if RUNGS[rung][1] == 8 else torch.bfloat16),
                # phase 11's: each rank's launches on the rung across ranks, by run
                multirank_launches={run: [by.get(key, 0) for by in ranks]
                                    for run, ranks in s11_launches.items()},
            ))
    log(f"(kernel, rung) pairs no served path ran (timed and swept, not in the kernels line): "
        f"{not_served}")
    record = dict(card=smi, build_s=build_s,
                  build_source_s=cuda_lib.build_info.get("source_seconds"), kernels=kernels,
                  picks=picks, gemms=gemms, grouped=grouped_rows, quant=quant_rows, serve=serve,
                  splitk_cases=sk_cases, splitk_errs=sk_errs, splitk_bitwise=sk_bitwise,
                  splitk_empty=sk_empty, splitk_fault=sk_fault, splitk_launches=sk_launches,
                  splitk_pairs=splitk_rows, compare=compare_rows,
                  compare_launches=compare_launches, compare_max_err=compare_err,
                  batched=batched,
                  sweep_cases=cases, b5_cases=b5_cases, b5_bitwise=b5_bitwise,
                  quant_cases=q_cases, quant_errs=q_errs, quant_bitwise=q_bitwise,
                  quant_b5_cases=qg_cases, quant_b5_errs=qg_errs, quant_b5_bitwise=qg_bitwise,
                  slice_max_err=slice_err, not_served=not_served, failures=failures,
                  b5_table=b5_rows, b5_s8_table=b5_s8_rows, b12_table=b12_rows,
                  b12_s8_table=b12_s8_rows, f32_table=f32_rows,
                  kv_int8=kv_int8, tune=tune, paged=paged, archs=archs, families=families,
                  train=train, shard=shard, multirank=multirank, serve_ranks=serve11,
                  families_ranks=families12, production_rules=production13, compiled=compiled,
                  phase_seconds=phase_s,
                  # every depth cut at full width, by phase (the layers each cut path ran)
                  depth_cuts={"3 int8 KV cache": KV_INT8_LAYERS, "5 (b)": PAGED_OLMOE_LAYERS,
                              "6": dict(ARCH_CELLS), "7": dict(FAMILY_CELLS), "8": dict(TRAIN_CELLS),
                              "8 stream": RESUME_LAYERS,
                              "10 (c)": MR_TRAIN_LAYERS, "11": MR11_LAYERS,
                              "11 (c)": MR11_DATA_LAYERS, "12": dict(MR12_CELLS),
                              "13 (a)": MR13_LAYERS, "13 (b)": MR13_ZAMBA_LAYERS,
                              "13 (b) cache": MR13_LONG_SEQ, "13 (c)": MR13_TRAIN_LAYERS},
                  seconds=time.perf_counter() - t_start)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(f"seconds by phase: {phase_s}")
    log(f"total {record['seconds']:.1f}s")
    if failures:
        for f in failures:
            log("FAILED:", f)
        return 1
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
