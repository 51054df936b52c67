#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the RAS pipeline on one GPU.

    python3 chip_smoke.py                  # the parent and its workers
    python3 chip_smoke.py --one-process    # every phase in this process
    python3 chip_smoke.py --worker heavy   # one worker's phases alone

The parent prints the card's name and power limit, builds every kernel,
and runs the timed kernel comparisons (phases 2-6, 5a and 9-11 below,
``PLAN["parent"]``) alone on the card.  Then it starts the workers
(``WORKERS``: ``serve``, ``heavy``, ``ladder``), each ``python3
chip_smoke.py --worker <name> --child``, which run the other phases on
the same card at once, each its list of ``PLAN`` in order; the phases
that pass objects stay in one worker, and the phases whose peaks the
card could not hold twice (mixtral, remat, tensor parallel, recurrent
placed, phi, vlm, audio) take turns in ``heavy``.  A phase starts when
its recorded peak (``PEAK_GIB``) fits beside the running phases' on the
card.  A worker loads the built kernels, prefixes its lines with its
name (``[heavy] ...``), holds the mamba2, mixtral and phi slices' B6 and
B2 timings until every other worker is done (then it has the card
alone), and hands the parent its records (launch counts, kernel times,
trainer cells) as one JSON line; the parent merges them into the one
``kernels`` line, after the dry-run phase (``PLAN["after"]``) has read
the trainers' cells.  A worker that exits nonzero, dies or sends no
record stops the others and the script (exit 1), with its name and last
lines on standard error.  Each phase prints its seconds and its peak of
memory reserved on the card; the parent prints each worker's wall time
and the whole script's.  ``--one-process`` runs every phase in
``PHASES``' order in one process, with the same checks and records;
``--worker <name>`` runs one worker's list alone (its held timings at
once), for debugging.

Phases (any failure raises and exits nonzero; the numbers name them,
``PHASES`` gives their one-process order and ``PLAN`` their processes):

1. print the card's name and power limit (``nvidia-smi``) and build every
   kernel from ``src/repro_torch/csrc/*.cu`` (one ``nvcc`` per source, in
   parallel);
2. kernel phases: the encode kernel (B1) and the decode-step kernel (B2)
   against their plain PyTorch versions on the card at the main-path
   shapes (128 lanes, K = 256, per-lane ``(T, lanes, K)`` tables, chunk 256
   with a ragged tail, plus an overflow case): outputs must be identical,
   and B2 must run its warp row path at every step and the exact bisection
   on rows with zero frequencies.  B1's call must be one kernel node of a
   CUDA graph (no memset), and B1 must equal its plain version on the
   encode edge cases (``ENCODE_EDGES``: every layout, chunk lengths 1 and
   around the kernel's gather lead, ragged tails, K from 2 to 4096, caps
   below the header, out-of-range symbols); B2 also on ``(freq, cdf)``
   pairs whose freq is not the cdf's differences.  Each is timed with CUDA
   events (median of repeats) beside its bound computed from this run's
   inputs; B2 also beside its launch floor, an empty kernel launched as B2
   is;
3. the full-stream decode (B3) and the slab decode (B4) on the same
   stream with top-4 candidates: B3 on the dense chunks, also truncated by
   3 bytes per cell; B4 straight off the packed v2 container, also on
   three index planes poisoned after validation.  Kernel, plain version
   and B3/B4 must agree on symbols, probe and underflow planes;
4. the Fig. 4(b) point: B3 on 64 lanes x 2048 ``image_rows`` with the
   static histogram table and each predictor; kernel == plain, and the
   probe totals must be exactly 1,046,915 / 650,352 / 552,027 (no
   predictor, ``NeighborAverage(4, 8)``, ``NeighborAverage(2, 4)``);
5. the image path at 1 megapixel (a 1024 x 1024 ``synthetic_image`` as
   256 lanes x 4,096): ``histogram_compress`` and the B1 static encode
   give byte-identical v1 containers, ``unpack`` ->
   ``histogram_decompress(predictor=NeighborAverage(4, 8))`` (B3) is
   bit-exact, the ``coder`` backend gives equal per-lane probes, with
   launch counters reset just before and read just after; B1's and B3's
   device times at these shapes;
5a. B3 and B4 on the table cases no main path reaches (``DECODE_CASES``:
   zero frequencies in a static table and in per-lane rows, prob_bits 16,
   K = 1000, 4096 and 5000, per-position rows, windows 1 and 16, a window
   wider than the kernel's probe tables), dense,
   truncated and off the packed container, each against its plain version;
6. a small-input reference check: the model's logits on the card agree
   with the same model's logits on the CPU;
7. the slice: ``ras-pimc`` at full width, 128 lanes x 600 tokens (1000
   before the tooling phases came), chunk 256, through
   ``lm_compress_chunked(backend="kernel")`` ->
   ``pack_chunked`` -> ``parse_chunked`` ->
   ``lm_decompress_chunked(backend="kernel")`` with launch counters reset
   just before and read just after (one B1, T B2 and T + 1 B6 launches:
   the compress side's table batch and each decoded position) and with no
   call of the sort-based ``spc.quantize_probs`` on the card; then the
   ``coder`` backend (the plain SPC) on the card must give a
   byte-identical container and equal per-lane probes;
8. the two-pass decode of the same container,
   ``lm_decompress_chunked(backend="two_pass")`` from the ``ContainerSlab``:
   bit-exact, per-lane probes equal to the fused decode's, and exactly one
   B4 launch between counters reset and read;
9. the records reference encode (B5) at B1's phase inputs:
   ``ops.rans_encode_records`` -> ``ops.compact_records`` with launch
   counters reset just before and read just after; kernel == plain on all
   three planes (also at ``t_block = 96``, so padded rows occur), and the
   compacted streams equal B1's byte for byte at the default cap and at
   ``cap // 3`` (overflow); one kernel node per call; kernel == plain on
   B1's edge cases, compacted equal to B1; B5, B5 plus compaction and B1
   timed side by side with the analytic stream bytes of both datapaths;
10. the Fig. 4(a) coder-speed point (128 lanes x 2048 ``image_rows(seed=0)``,
   the static ``tables_from_counts_np`` table): the single-lane ``PyRans``
   round trip on 40,000 symbols on the host; ``golden.encode`` == ``PyRans``
   == lane 0 of ``coder.encode``, ``coder.encode_records``, B1 and B5 plus
   ``compact_records``; all lanes byte-identical across them; ``coder.decode``
   (with and without the LUT) and B3 bit-exact; microseconds per symbol and
   speedups over ``PyRans`` beside the paper's figures;
11. the SPC conversion (B6): ``bench_spc.run``'s point (256 x 256
   ``dirichlet(0.5)``, seed 0), one decoded position of the slice (128 x
   256, BF16) and the slice's whole per-position table batch (B1's phase
   probabilities as 128,000 x 256, float32 and BF16): kernel ==
   ``spc_quantize_plain`` == ``tables_from_probs(...).freq``,
   ``spc_freq_cdf`` == ``freq_cdf_from_probs``, and
   ``ops.spc_quantize_tables`` == ``tables_from_probs`` (on the card, and
   on the CPU at the first point) on every plane with
   one B6 launch between counters reset and read;
12. row invariance (C3), before any scheduler code runs: why the engine
   calls the model once per slot, on a state of the request's own ring:
   at full width, 4 slots of 128 rows each stepped alone over 8 steps
   against the same rows inside one plain 512-row call, a batched GEMM of
   the 4 slots and 128 rows under a shorter ring, each difference printed
   (every logit finite);
13. prefill against step (C4): ``prefill_chunk`` over a 256-position chunk
   of 256 rows (pos0 > 0, one ragged row) bitwise equal to 256
   ``decode_step`` calls on every live logit and on the cache (a GEMM over
   all positions' rows is printed beside it);
14. ``benchmarks/bench_serve.py``'s point (16 streams x 2 lanes x 64
   symbols, chunk 16, 4 slots, Poisson 200 Hz, seed 0): a serial
   ``lm_compress_chunked(backend="kernel")`` + ``pack_chunked`` server
   against ``BatchEngine(step_backend="kernel", clock="wall")``, every
   blob byte-identical; streams/s, p50/p99 latency, prefill cycles;
15. the engine at full width (4 slots x 128 lanes, 300-token requests,
   chunk 256: a full chunk and a ragged tail): 4 compress requests
   (prefill cycles), then their blobs decompressed with 2 new compress
   requests queued behind them, with launch counters reset just before
   and read just after (B1 once per compress
   slot and cycle, B2 and B6 once per decode step, B6 once per cycle with
   compress rows), no sort-based SPC call on the card and every cycle's
   device half under ``torch.cuda.set_sync_debug_mode("error")``: blobs
   byte-identical to ``lm_compress_chunked``, tokens exact and per-lane
   probes equal to ``lm_decompress_chunked``; symbols/s each way; then on
   the 2 new requests' 16-symbol blobs, one 4-slot decompress cycle's
   device-busy share from ``torch.profiler`` with a container cut short
   retiring alone with ``StreamExhaustedError``, and the coder step
   backend's blobs, tokens and probes equal to the single-request kernel
   path's.
15a. placement (``placement_phase``), on a world-1 NCCL group started
   over a ``FileStore`` in a temp directory and destroyed at the end: (1)
   a chunk mesh at 128 lanes x 1,024 (four chunks of 256) with phase 2's
   kind of per-lane K = 256 tables: ``parallel.encode_chunked`` (one B1)
   byte-identical to ``ops.rans_encode_chunked`` and
   ``coder.encode_chunked``, ``parallel.decode_chunked`` with top-4
   candidates from dense chunks and from the parsed container (one B3
   each) equal to the single-device kernel path in symbols and per-lane
   probes; (2) ranks 0 and 1 of a 2-rank chunk mesh run in turn and
   stitched, byte-identical; (3) the slice (``ras-pimc`` ``CONFIG``, 128 x
   600, chunk 256, top-4) on a lane mesh: ``lm_compress_chunked`` gives
   the slice's container byte for byte (B1 1, B6 1), the fused decode is
   bit-exact with the slice's per-lane probes (B2 600, B6 600), two-pass
   pass 2 on the chunk mesh gives the same symbols and probes (B3 2); (4)
   lanes 0-63 and 64-127 of the first 256 tokens priced and decoded as
   two ranks would: each round-trips, each kernel container equals its
   coder container, and the card's row-invariance finding is printed (the
   stitched containers against the unplaced one of those tokens, the
   largest |dlogit| of a row at 64 rows
   against 128 over 64 positions); (5) phase 14's point through
   ``BatchEngine(mesh=lane_mesh())``, every blob equal; (6) 5 cross-pod
   train steps of 16 x 128 at full width on a 1-rank pod mesh, one int8
   scale per leaf of the reference's tree (counted): residuals ``x + e -
   dequant(quant(x + e))`` with the group's scale bitwise, the card's
   reduce equal to the CPU's (a gloo group) bitwise, the loss falling;
   (7) that state with its error tree checkpointed and ``remesh``-ed onto
   the CPU and back, bitwise.
15b. the placed engine (``placed_engine_phase``), on a world-1 NCCL
   group: the slice's ``ras-pimc`` model placed for compute on
   ``make_mesh_for(1)`` served by ``BatchEngine`` at phase 15's point
   (4 slots x 128 lanes x 300 tokens): every blob byte-identical to phase
   15's unplaced engine's and to the placed ``lm_compress_chunked``'s,
   two of them decompressed exactly side by side, launches B1 8 / B2 300
   / B6 302 from 0; then
   ``mamba2-130m`` ``CONFIG`` cut to 4 layers (K = 50,280, prob_bits 16),
   2 slots x 16 lanes x 64 tokens, alike against its unplaced engine
   (B1 4 / B2 64 / B6 66).
16. the Fig. 4(c) ratio ladder (``benchmarks/bench_ratio.run``'s
   defaults: a 128 x 256 ``synthetic_image(seed=0)`` as 16 lanes x 2048,
   chunk 512): zlib level 9, the static histogram, ``ras-pimc`` trained
   120 steps (8 x 128, lr 3e-3) at full width and at the smoke width, each
   (the full width on each lane's first 256 symbols only) through
   ``lm_compress_chunked(backend="kernel")`` (byte-identical to the coder
   backend's container) and the fused kernel decode (bit-exact; one B1,
   T B2 and T + 1 B6 launches), and the bits-back VAE trained
   300 steps (lr 1e-2) coding the image's 512 8 x 8 patches:
   ``bb_encode`` on both pop backends (byte-identical stacks), ``bb_decode``
   through B2 (pixels exact, the initial stack restored, no underflow; one
   B2 launch per pop), its tables' SPC through B6, and no sort-based SPC
   on the card on any of these kernel paths.  Every ratio is printed
   beside the reference's ``BENCH_ratio.json`` figure; the phase's
   launches are counted from 0.
Each phase prints its seconds, its peak of reserved memory and its
process's running total, on standard output and on standard error.  Every
B2/B3/B4 launch is also held to the
code path it must run (``rans_decode.last_branches``): B2's warp row path
on the slice's rows and its read-ahead bisection on the zoo's rows of
32,064 to 50,280 entries, the slot-table path
on the static tables of phases 4, 5 and 10, the warp row search on the
per-lane rows of phases 3 and 8, and the exact bisection on the
zero-frequency cases of 5a.

17. the recurrent families (``mamba2_phase``): ``mamba2-130m`` at full
   width (d_model 768, BF16, vocab 50,280), its depth cut to 4 of 24
   layers (6 before the recurrent placement checks came, 12 before the
   MoE placement checks came, the whole model before the tooling phases
   came), on seeded random weights, 16 lanes
   x 256 ``token_stream`` tokens, chunk 128,
   ``prob_bits=16``, top-4: ``lm_compress_chunked`` on the kernel backend
   (one B6 batch of 4,096 x 50,280, one B1) and on the coder backend give
   byte-identical containers, the fused decode (B6 and B2 per position)
   is bit-exact with per-lane probes equal to the coder decode's,
   launches exactly B1 1 / B2 256 / B6 257 with no sort-based SPC on the
   card, peak memory printed; B6 (its wide layout) at (16, 50,280) with
   the CDF and at (4,096, 50,280), and at K = 16,385 and 65,536, and B2 at
   (16, 50,280), each against its plain version and timed beside its
   bound; the full width in float32 on the card against the CPU (2 rows x
   4 steps, logits within 1e-4); the engine (2 slots x 16 lanes, max_len
   128) on requests of 256 and 128 tokens, blobs byte-identical to
   ``lm_compress_chunked``, decodes exact; and ``recurrentgemma-2b`` SMOKE
   (a (rec, rec, attn) pattern, a (rec,) tail, a 16-slot local window
   wrapping 4 times at 8 lanes x 64): kernel and coder containers
   byte-identical, fused decode exact, and an engine run whose short
   last chunk freezes a slot, ``prefill="auto"`` stepping down.  Then the
   SSM family's compute placement (slice 17, :func:`_placed_serve`) on a
   world-1 NCCL group and ``make_mesh_for(1)``: the same 4-layer model
   placed (its 1,536 SSM channels, 128-wide state and conv state over
   ``model``), 16 rows decoded for 32 positions with each step's logits
   and every state leaf bitwise the plain model's, then 16 lanes x 128
   tokens, chunk 64, through ``lm_compress_chunked`` and
   ``lm_decompress_chunked(backend="kernel")``: the container
   byte-identical to the whole model's, the round trip exact, the probes
   equal, launches exactly B1 1 / B2 128 / B6 129
   (``recurrent_placed_launches``) and symbols/s each way; the dry-run of
   the placed decode cell on the 1 x 1 mesh gives the card's parameter
   and state bytes.

18. the MoE family (``moe_phase``): ``mixtral-8x22b`` at full width
   (d_model 6,144, 48 heads x 128, 8 kv heads, d_ff 16,384, 8 experts
   top-2, a 4,096-position sliding window, vocab 32,768, BF16, an untied
   head), its depth cut to 2 of 56 layers (4 before the tooling phases
   came), on seeded random weights drawn
   on the card, 16 lanes x 512 ``token_stream`` tokens, chunk 128,
   ``prob_bits=16``, top-4: kernel and coder containers byte-identical,
   the fused decode bit-exact with per-lane probes equal to the coder
   decode's, launches exactly B1 1 / B2 512 / B6 513 with no sort-based
   SPC on the card, peak memory printed; a step's time and device-busy
   share beside the bytes of weights it reads; B6 at (16, 32,768) with the
   CDF and at (8,192, 32,768), and B2 at (16, 32,768), each against its
   plain version and timed beside its bound; one full-width layer in
   float32 on the card against the CPU (2 rows x 4 steps, logits within
   1e-4); the engine (2 slots x 16 lanes, max_len 512, ``prefill="auto"``)
   on requests of 512 and 128 tokens, with prefill cycles and no host
   sync in a
   cycle, blobs byte-identical to ``lm_compress_chunked``, decodes exact;
   and ``mixtral-8x22b`` SMOKE at 8 lanes x 64, its 16-slot window
   wrapping: kernel and coder containers byte-identical, decode exact.
   Then the MoE family's compute placement (slice 16,
   :func:`_placed_serve`), on a world-1 NCCL group and
   ``make_mesh_for(1)``: the same 2-layer model placed
   (``parallel.sharding.place_model``; 8 experts do not divide over
   ``cfg.tp`` 16, so per-expert tensor parallelism), 16 rows decoded for
   32 positions with each step's logits bitwise the plain model's, then
   16 lanes x 128 tokens, chunk 64, through ``lm_compress_chunked`` and
   ``lm_decompress_chunked(backend="kernel")``: the container
   byte-identical to the whole model's, the round trip exact, the probes
   equal, launches exactly B1 1 / B2 128 / B6 129 (``moe_placed_launches``)
   and symbols/s each way; the dry-run of the placed decode cell on the
   1 x 1 mesh gives the card's parameter and state bytes.

19. the Fig. 4(c) zoo rungs (``zoo_phase``, ``bench_ratio._zoo_frontier``:
   the Fig. 4(c) image's 16 lanes x their first 256 symbols, chunk 128):
   ``mamba2-130m`` and ``recurrentgemma-2b`` SMOKE trained 60 steps (8 x
   128, lr 3e-3) on the card and phase 16's ``ras-pimc`` SMOKE, each
   through the kernel backend (kernel and coder containers
   byte-identical, fused decode bit-exact, no plain SPC on the card), the
   phase's launches counted from 0 (B1 3, B2 768, B6 771); every CR,
   bits/symbol and model entropy beside ``BENCH_ratio.json``'s;
20. ``mamba2-130m`` at full width as a trainer (``mamba2_train_phase``):
   3 BF16 train steps of 4 x 512 ``token_stream`` tokens with its
   config's activation checkpointing (losses, step time, peak memory),
   then 2 more without it (the step time and peak printed beside), then
   its first step in float32 on the card and on the CPU from the same
   weights at 2 x 256 (loss and gradient norm within 1e-4 relative);
21. the dense zoo (``dense_zoo_phase``): ``qwen3-4b`` (QK norm, 32 x 128
   heads over d_model 2,560) and ``qwen1.5-4b`` (QKV bias, 20 heads padded
   to 32 over 20 kv heads) at full width cut to one float32 layer, the
   biases, norm scales and padded heads drawn off their inits, card
   against CPU (4 decode steps of 2 rows and a 256-token forward, logits
   within 1e-4); ``llama3-405b``'s blockwise attention at ``qwen3-4b``'s
   heads (S 2,048, ``attn_block`` 1,024) against the naive schedule on
   the card (within 1e-4, both timed); the four dense SMOKE models at 8
   lanes x 64 through the kernel backend (launches counted, containers
   byte-identical to the coder's, decode exact);
21a. activation checkpointing (``remat_phase``): ``qwen3-4b``'s
   ``train_4k`` config (BF16, naive attention) at full width cut to 8 of
   36 layers, one batch of 1 x 4,096 ``train_batch`` tokens, from the same
   seeded weights with ``remat=False``, ``remat=True`` and ``remat=False``
   again: losses bitwise equal, each gradient leaf of the checkpointed run
   bitwise equal to the plain one or no farther from it than the plain
   repeat (both printed), the forward and backward's peaks; one train
   step of each, timed, the checkpointed step's peak memory below both
   plain steps'; each beside the dry-run's reckoned total on the 1 x 1
   mesh (parameter, gradient and moment bytes equal to the card's) and
   the card's name and power limit;
21b. tensor-parallel compute (``tensor_parallel_phase``), on a world-1
   NCCL group and ``launch.mesh.make_mesh_for(1)``, a (1, 1)
   ``DeviceMesh``: ``qwen3-4b`` ``CONFIG`` at full width (32 heads at
   ``tp=16``, 8 replicated kv heads, d_ff 9,728, vocab 151,936) cut to 2
   of 36 layers, float32, naive attention, no remat, 2 x 1,024
   ``train_batch`` tokens, drawn on the card; the plain model against
   ``parallel.sharding.place_model`` of the same weights with
   ``act_pspec`` None and sequence-parallel: ``grads_fn``'s loss and
   every gradient leaf, the prefill logits, and every parameter after
   two ``make_train_step`` steps (the first at the warmup's zero learning
   rate) within 1e-5 of the leaf's largest entry (the largest seen
   printed); the second step's time and the steps' peak memory of each;
   the dry-run of each placed cell on the 1 x 1 mesh gives the card's
   parameter, gradient and moment bytes,
   its total printed beside the peak, with the card's name and power
   limit.  No rANS kernel runs (counted);
21c. the recurrent families' compute placement
   (``recurrent_placed_phase``) on the same world-1 mesh: ``mamba2-130m``
   ``CONFIG`` cut to 2 of 24 layers in float32 (2 x 1,024 tokens) and
   ``recurrentgemma-2b`` ``CONFIG`` cut to one (rec, rec, attn) pattern,
   3 of 26 layers, in float32 (1 x 2,048), their SSM and RG-LRU leaves of
   constant init moved off by seeded draws (every head's ``A_log``,
   ``dt_bias`` and ``D`` alike would hide a rank reading another head's,
   and a leaf of zeros moves by the learning rate alone in two steps),
   each trained plain and then placed (:func:`_placed_train`: loss,
   gradients, prefill logits and parameters after two steps within 1e-5
   of each leaf's largest entry,
   step times and peaks, the train cell's dry-run bytes); the hybrid
   decoding 2 rows x 32 positions into its 2,048-slot ring placed
   (bitwise the plain model's) and with ``slots_at_one`` (the
   context-parallel ``slots`` step on one rank: logits and state within
   1e-5), the layout each step ran printed, and the decode cell's
   dry-run bytes.  No rANS kernel runs (counted);
22. the decode's first-index top-k (``topk_phase``): card equal to the
   CPU on built ties at 16 x 32,768, timed beside ``torch.topk``;
23. ``phi3.5-moe-42b-a6.6b`` at full width (``phi_phase``: d_model 4,096,
   32 heads x 128 over 8 kv heads, 16 experts top-2, d_ff 6,400, vocab
   32,064 padded to 32,256, BF16, untied head), its depth cut to 2 of 32
   layers (4 before the tooling phases came), drawn on the card, 16 lanes
   x 256 ``token_stream`` tokens, chunk 128, ``prob_bits=16``: kernel and
   coder containers
   byte-identical, the fused decode bit-exact with equal per-lane probes,
   launches exactly B1 1 / B2 256 / B6 257, B6 fed the 32,064 true
   symbols; a 16-row step and its busy share beside its byte bound; B6
   (batch, and per position with the CDF) and B2 at K = 32,064 against
   their plain versions; one float32 layer card vs CPU (logits within
   1e-4).  The compute placement of slice 16: the 2-layer model placed
   (16 experts over ``cfg.tp`` 16: expert parallelism) through the
   checks of phase 18's :func:`_placed_serve`; and the float32 layer
   (the ``CONFIG`` cut to 1 of 32 layers, :func:`_placed_train`)
   trained plain and then placed on 2 x 512 ``train_batch`` tokens:
   ``grads_fn``'s loss and every gradient leaf, the prefill logits and
   every parameter after two steps within 1e-5 of each leaf's largest
   entry, step times and peaks, the dry-run of the placed train cell on
   the 1 x 1 mesh giving the card's parameter, gradient and moment
   bytes;
24. cross attention (``vlm_phase``): ``llama-3.2-vision-11b`` whole (40
   layers, 8 of them ``cross``, BF16, drawn on the card) against a
   ``train_batch`` memory of 2 x 4,096 x 4,096 in BF16: greedy
   ``generate`` of 2 rows x 16 + 32 tokens twice (identical tokens,
   finite logits), a step's time beside the bytes of its weights and
   memory and the FLOPs of its memory projections; one (attn, cross)
   pattern at full width in float32 card vs CPU (memory cut to 512
   tokens; 4 decode steps and a 64-token forward within 1e-4); 2 BF16
   train steps of 2 x 256 tokens at 5 of 40 layers with the config's
   activation checkpointing (finite losses, step time, peak memory), then
   2 without it (step time and peak printed beside).  The float32 cut,
   its norm scales moved off their ones, placed for compute on the
   world-1 mesh 1 x 1 (:func:`_ed_placed`; 8 kv heads replicated over
   ``cfg.tp`` 16): trained plain and placed on 2 x 256 tokens and their
   4,096-token memory (loss, gradients, prefill logits and parameters
   after two steps within 1e-5 of each leaf's largest entry), a greedy
   decode of 2 rows x 32 positions against a memory (placed: logits,
   state and tokens bitwise the plain model's; with ``slots_at_one`` the
   ``slots`` ring step within 1e-5, the tokens equal), and the dry-run of
   the placed train and decode cells at the card's bytes;
25. the encoder-decoder (``audio_phase``): ``seamless-m4t-large-v2`` whole
   (24 encoder + 24 ``dec`` layers, BF16): 2 x 1,024 x 1,024 encoder
   inputs through ``encode_memory``, then ``generate`` as in 24; one
   encoder and one ``dec`` layer in float32 card vs CPU (the encoder's
   output, 4 decode steps and a 64-token forward within 1e-4); 2 BF16
   train steps at full depth, with and without activation checkpointing,
   as in 24; the float32 cut placed as in 24 (16 kv heads sharded over
   ``cfg.tp`` 16; its encoder placed too, the decode's memory each
   model's ``encode_memory`` of the same inputs, bitwise).
20a. (right after 20) the BF16 checkpoint (``bf16_checkpoint_phase``):
   the ``mamba2-130m`` BF16 train state of phase 20 saved with
   ``train.checkpoint.save`` and restored into a fresh state on the card,
   every leaf bitwise; bytes and seconds;
26. the fault-tolerant trainer (``trainer_phase``), the slice's path:
   ``examples/train_small_lm.run`` at ``ras-pimc``'s full width, 50 steps
   of 16 x 128 under the ``RestartManager`` (a checkpoint every 25 steps,
   one fault before step 30: exactly one restart), bitwise equal to an
   unbroken run, then held-out 8 x 256 tokens through the kernel
   backend: launches B1 1 / B2 256 / B6 257 from 0, round trip exact,
   kernel and coder containers byte-identical, CR above the static
   histogram's; the full-width state saved and restored bitwise;
26a. the placed cross-pod step (``crosspod_placed_phase``), on a world-1
   NCCL group: ``ras-pimc`` ``CONFIG`` in float32 placed on a ``(pod 1,
   data 1, model 1)`` device mesh, the int8 ring on its ``pod`` group, 6
   steps of 16 x 128 from step 100: the first bitwise its composition
   (placed gradients, the ring with one whole scale per leaf of the
   reference's tree, counted against its leaves, the clip, AdamW, the
   residuals, the loss); against the unplaced cross-pod step on the same
   pod mesh the gradients and losses within 1e-5 and the reduces equal
   but for counted one-code differences at rounding boundaries; step ms
   of both beside the card's name and power limit;
27. the launchers (``launchers_phase``): ``launch.train.main`` (10 steps,
   a checkpoint every 5) then ``launch.serve.main --ckpt --backend
   kernel`` in process: ``restored checkpoint step 10``, bit-exact,
   launches B1 1 / B2 256 / B6 257;
28. the examples (``examples_phase``): quickstart, compress_images and
   compress_latents with all their checks, launches counted per example;
29. ``bench_lanes`` (``lanes_phase``): the coder and B1 byte-identical, B4
   zero-copy exact, container bytes 8,599 / 33,851 / 138,574 as the
   committed ``BENCH_lanes.json``; Msym/s per lane count;
30. ``bench_chunked`` (``chunked_phase``): all nine points' bits/symbol
   and flush overhead equal to ``BENCH_chunked.json``, B1 byte-identical
   to the coder on each;
31. the production mesh and the dry-run (``mesh_dryrun_phase``), on a
   world-1 NCCL group: (a) ``launch.mesh.make_mesh_for(1)`` is a (1, 1)
   ``DeviceMesh`` and ``parallel.sharding.shard_params``/``unshard`` of
   the ``ras-pimc`` ``CONFIG`` parameters round-trip bitwise; (b)
   ``launch.dryrun.run_cell`` of the mamba2 trainer (BF16 4 x 512), the
   vlm trainer (5 layers, 2 x 256, two microbatches) and a ``ras-pimc``
   trainer run here (16 x 128) on the 1 x 1 mesh gives the card's
   parameter, gradient and AdamW-moment bytes exactly, its total printed
   beside ``max_memory_allocated`` (the mamba2 and vlm trainers run and
   are reckoned with their configs' activation checkpointing); (c) the ``ras-pimc`` step's traced
   FLOPs over its measured step time as a share of the 67 TFLOP/s float32
   peak, with the card's name and power limit; (d) B3 and B4 (K = 256,
   1,000, 4,096, 5,000) and B2 (K = 256, 32,064, 32,768, 50,280) report
   the code path ``kernels.autotune``'s plan gives them, with and without
   zero frequencies.  The dry-run launches no kernel (counted).

The kernels' JSON record gives each kernel's launches on its main path
(``launches``), in the engine phase (``engine_launches``), in the
placed calls of phase 15a (``placement_launches``), in the placed
engine of phase 15b (``placed_engine_launches``), in phase 26a
(``crosspod_placed_launches``, 0), in the
Fig. 4(c) phase (``fig4c_launches``), in the mamba2 slice
(``mamba2_launches``), in the mixtral slice (``moe_launches``), in
the zoo rungs (``zoo_launches``), in the phi slice
(``phi_launches``), in the placed MoE compress and decompress of
phases 18 and 23 (``moe_placed_launches``, both models), in phase 21b
(``tensor_parallel_launches``) and
in phases 26-30 (``trainer_launches``,
``launchers_launches``, ``examples_launches``, ``lanes_launches``,
``chunked_launches``), in the dry-run of phase 31 (``dryrun_launches``,
0), and B6's and B2's times at K = 50,280, K = 32,768
and K = 32,064.  The last
two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Exits nonzero without CUDA or outside
a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

LANES, T, K, CHUNK, TOPK = 128, 1000, 256, 256, 4
# the slice's main path: two full chunks and a ragged tail (1000 tokens
# before the tooling phases came, cut for the script's time limit)
SLICE_T = 600
FIG4B_LANES, FIG4B_T = 64, 2048                # BENCH_search.json's point
FIG4B_TOTALS = (1046915, 650352, 552027)       # its committed probe totals
FIG4A_LANES, FIG4A_T, FIG4A_PY = 128, 2048, 40_000   # bench_speed.run's point
SPC_POINT = (256, 256)                          # bench_spc.run's point
RECORDS_T_BLOCK = 96                            # pads 256 and 232 to 288
# a 1-megapixel 8-bit image (4 megapixels until the script neared its time
# limit: the coder backend and the plain B3 walk every column on the host)
IMAGE_SIDE, IMAGE_LANES = 1024, 256
# benchmarks/bench_ratio.run's defaults: a 128 x 256 synthetic_image(seed=0)
# as 16 lanes x 2048 symbols, chunk 512; _train_arch's 120 steps of 8 x 128
# at lr 3e-3; _latent_rung's 300 VAE steps at lr 1e-2, 8 x 8 patches
FIG4C_H, FIG4C_W, FIG4C_LANES, FIG4C_CHUNK = 128, 256, 16, 512
FIG4C_STEPS, FIG4C_BATCH, FIG4C_SEQ, FIG4C_LR = 120, 8, 128, 3e-3
FIG4C_VAE_STEPS, FIG4C_VAE_LR, FIG4C_VAE_CAP = 300, 1e-2, 1024
# the full-width ras-pimc rung (not on the reference's ladder) codes each
# lane's first 256 symbols, half a chunk (the first chunk until the
# recurrent placement checks came); all 2,048 symbols cost it about 100 s
# of the script's time limit, each position a host-bound model step
FIG4C_FULL_T = FIG4C_CHUNK // 2


def _bound(moved: int, ops: int) -> tuple[float, str]:
    """The least time for the work, in ms, and what bounds it: the bytes
    moved over the memory rate or the integer operations over the INT32
    rate, whichever is larger (``repro_torch.analysis.roofline``, the
    port's one source of the card's published peaks)."""
    from repro_torch.analysis.roofline import kernel_bound
    return kernel_bound(moved, ops)


def _median_ms(fn, repeats: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_ms(fn, n: int, repeats: int = 5) -> float:
    """Device time per call: ``n`` calls captured in one CUDA graph, the
    graph replayed between two events (median of ``repeats``), over ``n``.
    Host work of the wrapper is outside the graph, so this is the kernel's
    own time (plus any allocation or memset nodes the wrapper issues)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return _median_ms(graph.replay, repeats, warmup=1) / n


def _check(ok, what: str) -> None:
    """Fail the run (kept under ``python -O``, unlike ``assert``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _branch(name: str, want: set, what: str) -> None:
    """B2's, B3's or B4's last launch ran exactly the code paths ``want``
    (``rans_decode.BRANCH_BITS`` names)."""
    from repro_torch.kernels import rans_decode
    got = rans_decode.last_branches(name)
    _check(got == want, f"{what}: {name} ran {sorted(got)}, expected "
           f"{sorted(want)}")


def _step_branches(freq) -> set:
    """The code paths B2's plan names for a launch on ``freq`` rows: the
    register row's warp row count, or the read-ahead bisection of a row
    longer than the registers."""
    from repro_torch.kernels import autotune
    return autotune.decode_step_plan(freq.shape[-1], 1).branches()


def _only(**counts) -> dict:
    """The launch counts of a path that runs exactly these kernels."""
    from repro_torch.kernels import LAUNCHES
    return {name: counts.get(name, 0) for name in LAUNCHES}


def _max_abs_err(got, ref) -> int:
    """Max |kernel - plain| over all outputs; the outputs must be equal."""
    err = 0
    for a, b in zip(got, ref):
        _check(a.shape == b.shape, f"output shapes {tuple(a.shape)} vs "
               f"{tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.long() - b.to(a.device).long()).abs().max()))
    _check(err == 0, f"kernel and plain version disagree (max abs err {err})")
    return err


def _graph_nodes(fn) -> list[str]:
    """The device work of one call of ``fn``: the kind (``KERNEL``,
    ``MEMSET``, ``MEMCPY``, ...) of each node of a CUDA graph that captured
    it, read from the graph's DOT dump (written under ``build/``)."""
    import re
    import torch
    from repro_torch.kernels import _build
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        fn()
    path = _build.BUILD_DIR.parent / "graph_nodes.dot"
    path.parent.mkdir(parents=True, exist_ok=True)
    graph.debug_dump(str(path))
    text = path.read_text()
    path.unlink()
    # one declaration per node: "graph_1_node_0"[... label="{KERNEL | ...
    return re.findall(r'"graph_\d+_node_\d+"\s*\[[^\]]*?label="\{?(\w+)',
                      text)


# encode edge cases beyond the main shapes (chunk lengths around the
# kernels' lookup lead D = 48 steps, ragged tails, K from 2 to above the
# shared-memory table limit, caps below the header): (K, chunk)
ENCODE_EDGES = ((2, 1), (256, 47), (2048, 48), (4096, 49), (256, 256))
EDGE_LANES, EDGE_T = 40, 300       # a partial warp; ragged tails
EDGE_OOB = 0.03                    # share of out-of-range symbols


def _encode_edges(dev):
    """The encode edge cases on ``dev``: ``(name, symbols, tables,
    chunk)`` for every layout and ENCODE_EDGES entry, with out-of-range
    symbols (negative, K and far above) mixed in."""
    import numpy as np
    import torch
    from repro_torch.core import spc
    for li, layout in enumerate(("static", "perpos", "lane")):
        for k, chunk in ENCODE_EDGES:
            rng = np.random.default_rng(1000 * li + k + chunk)
            shape = {"static": None, "perpos": EDGE_T,
                     "lane": (EDGE_T, EDGE_LANES)}[layout]
            probs = rng.dirichlet(np.full(k, 0.5), size=shape).astype(
                np.float32)
            tbl = spc.tables_from_probs(torch.as_tensor(probs, device=dev))
            syms = rng.integers(0, k, (EDGE_LANES, EDGE_T))
            bad = rng.random(syms.shape) < EDGE_OOB
            syms[bad] = rng.choice([-1, -2**31, k, k + 1000, 2**31 - 1],
                                   int(bad.sum()))
            yield (f"{layout} K={k} chunk {chunk}",
                   torch.as_tensor(syms.astype(np.int32), device=dev), tbl,
                   chunk)


def encode_phase(dev):
    import torch
    from repro_torch.core import spc
    from repro_torch.data.pipeline import token_stream
    from repro_torch.kernels import rans_encode
    from repro_torch.core.coder import default_cap

    gen = torch.Generator(device=dev).manual_seed(1)
    logits = torch.randn((T, LANES, K), generator=gen, device=dev) * 3.0
    tables = spc.tables_from_probs(
        spc.store_bf16(torch.softmax(logits, -1)))
    syms = torch.as_tensor(token_stream(K, (LANES, T), seed=1),
                           dtype=torch.int32, device=dev)
    cap = default_cap(CHUNK)

    def call(c):
        return rans_encode.rans_encode_lanes(syms, tables, c, CHUNK)

    def plain(c):
        return rans_encode.rans_encode_lanes_plain(syms, tables, c, CHUNK)

    got, ref = call(cap), plain(cap)
    torch.cuda.synchronize()
    err = _max_abs_err(got, ref)
    _check(not bool(ref[3].any()), "default cap overflowed")
    small = cap // 3                 # overflow case: some cells outgrow it
    ovf_got, ovf_ref = call(small), plain(small)
    torch.cuda.synchronize()
    err = max(err, _max_abs_err(ovf_got, ovf_ref))
    _check(bool(ovf_ref[3].any()), "overflow case did not overflow")
    print(f"B1 encode: kernel == plain at ({LANES} lanes, T={T}, K={K}, "
          f"chunk {CHUNK}, cap {cap}) and at cap {small} "
          f"({int(ovf_ref[3].sum())} overflowed cells flagged)", flush=True)
    nodes = _graph_nodes(lambda: call(cap))
    _check(nodes == ["KERNEL"], f"B1's call runs {nodes} on the device, not "
           "one kernel")
    t0 = time.perf_counter()
    n_edges = 0
    for name, esyms, etbl, chunk in _encode_edges(dev):
        ecap = default_cap(chunk)
        for c in (ecap, 1, 3, 4, ecap // 3):
            err = max(err, _max_abs_err(
                rans_encode.rans_encode_lanes(esyms, etbl, c, chunk),
                rans_encode.rans_encode_lanes_plain(esyms, etbl, c, chunk)))
            n_edges += 1
    torch.cuda.synchronize()
    print(f"B1 encode: one kernel node per call (no memset); kernel == plain"
          f" on {n_edges} edge cases ({EDGE_LANES} lanes x {EDGE_T}, every "
          f"layout, (K, chunk) in {ENCODE_EDGES}, caps default, 1, 3, 4 and "
          f"a third, {EDGE_OOB:.0%} out-of-range symbols; "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    ms = _device_ms(lambda: call(cap), n=10)
    call_ms = _median_ms(lambda: call(cap), repeats=30)
    plain_ms = _median_ms(lambda: plain(cap), repeats=3, warmup=1)
    n_chunks = ref[0].shape[0]
    moved = (LANES * T * (4 + 5 * 4)           # symbol + five gathered planes
             + n_chunks * LANES * (cap + 9))   # streams + start/len/overflow
    ops = LANES * T * 10                        # ~10 integer ops per step
    bound_ms, bound_by = _bound(moved, ops)
    print(f"B1 encode: {ms:.4f} ms kernel on the device ({call_ms:.4f} ms "
          f"per wrapper call), {plain_ms:.2f} ms plain, bound "
          f"{bound_ms:.6f} ms by {bound_by} ({moved} B moved, {ops} ops); "
          f"each (chunk, lane) cell walks {CHUNK} dependent steps: "
          "latency-bound", flush=True)
    return dict(name="rans_encode_lanes", route="cuda",
                source="src/repro_torch/csrc/rans_encode.cu",
                replaces="src/repro/kernels/rans_encode.py:469",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                call_ms=call_ms), (syms, tables, got)


def decode_phase(dev, encoded):
    import torch
    from repro_torch.core import coder, spc, u32
    from repro_torch.core.bitstream import ChunkedLanes
    from repro_torch.kernels import rans_decode

    syms, tables, enc_out = encoded
    enc = coder.chunk_encoded(ChunkedLanes(*enc_out), 0)
    buf = enc.buf.contiguous()
    dec = coder.decoder_init(enc)
    s0, p0 = u32.bits(dec.s), dec.ptr.to(torch.int32)
    cands = torch.topk(tables.freq[:CHUNK], TOPK, dim=-1).indices.to(
        torch.int32)                         # (CHUNK, lanes, topk)
    err = 0
    sk, pk, sp, pp = s0, p0, s0, p0
    for t in range(CHUNK):
        args = (tables.freq[t], tables.cdf[t])
        got = rans_decode.rans_decode_step(buf, sk, pk, *args,
                                           candidates=cands[t])
        ref = rans_decode.rans_decode_step_plain(buf, sp, pp, *args,
                                                 candidates=cands[t])
        err = max(err, _max_abs_err(got, ref))
        _branch("rans_decode_step", {"warp_rows"}, f"B2 step {t}")
        _check(torch.equal(ref[2], syms[:, t]), "plain decode lost a symbol")
        sk, pk, sp, pp = got[0], got[1], ref[0], ref[1]
    torch.cuda.synchronize()
    _check(int(ref[4].sum()) == 0 and torch.equal(
        pp.long(), (enc.start + enc.length).long()),
        "decode did not end exactly at the stream ends")
    # rows with zero frequencies (every third lane): the exact bisection
    zf = tables.freq[0].clone()
    zf[::3, 128] += zf[::3, 3:7].sum(-1)
    zf[::3, 3:7] = 0
    zt = spc.build_tables(zf)
    zargs = (buf, s0, p0, zt.freq, zt.cdf)
    err = max(err, _max_abs_err(
        rans_decode.rans_decode_step(*zargs, candidates=cands[0]),
        rans_decode.rans_decode_step_plain(*zargs, candidates=cands[0])))
    _branch("rans_decode_step", {"warp_rows", "warp_bisect"},
            "B2 on zero-frequency rows")
    # a (freq, cdf) pair whose freq is not the cdf's differences: f comes
    # from freq on every path, as in the reference
    gen_f = torch.Generator(device=dev).manual_seed(2)
    for f_rows, c_rows in ((tables.freq[1], tables.cdf[1]),
                           (tables.freq[1][0], tables.cdf[1][0])):
        bent = (f_rows + torch.randint(0, 3, f_rows.shape, generator=gen_f,
                                       device=dev,
                                       dtype=torch.int32)).contiguous()
        for cand in (cands[1], None):
            margs = (buf, s0, p0, bent, c_rows)
            err = max(err, _max_abs_err(
                rans_decode.rans_decode_step(*margs, candidates=cand),
                rans_decode.rans_decode_step_plain(*margs, candidates=cand)))
            _branch("rans_decode_step", {"warp_rows"},
                    "B2 on a mismatched (freq, cdf) pair")
    print(f"B2 decode step: kernel == plain at every one of {CHUNK} steps "
          f"over a {LANES}-lane stream (per-lane (lanes, K) rows, top-{TOPK}"
          " candidates; warp row path at every step), on rows with zero "
          "frequencies (warp rows and the exact bisection) and on "
          "(freq, cdf) pairs with freq != diff(cdf), per-lane and shared, "
          "with and without candidates", flush=True)
    step_args = (buf, s0, p0, tables.freq[0], tables.cdf[0])
    def step():
        return rans_decode.rans_decode_step(*step_args, candidates=cands[0])

    floor_ms = _device_ms(lambda: rans_decode.rans_decode_step_floor(
        *step_args, candidates=cands[0]), n=100)
    ms = _device_ms(step, n=100)
    call_ms = _median_ms(step, repeats=200, warmup=10)
    plain_ms = _median_ms(lambda: rans_decode.rans_decode_step_plain(
        *step_args, candidates=cands[0]), repeats=20)
    one = rans_decode.rans_decode_step_plain(*step_args, candidates=cands[0])
    bound_ms, bound_by, moved, ops = _b2_bound(one, p0, TOPK)
    print(f"B2 decode step: {ms:.4f} ms kernel on the device "
          f"({call_ms:.4f} ms per wrapper call), launch floor {floor_ms:.4f} "
          f"ms (an empty kernel with B2's grid, block and arguments), "
          f"{plain_ms:.3f} ms plain, bound {bound_ms:.8f} ms by {bound_by} "
          f"({moved} B moved, {ops} ops)", flush=True)
    return dict(name="rans_decode_step", route="cuda",
                source="src/repro_torch/csrc/rans_decode_step.cu",
                replaces="src/repro/kernels/rans_decode.py:560",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                call_ms=call_ms, floor_ms=floor_ms)


def _b2_bound(one, p0, topk: int):
    """B2's bound on one pop whose plain outputs are ``one`` from cursors
    ``p0``: ``(ms, bound_by, bytes moved, ops)``.  A lane pays min(probes,
    topk) candidate checks (cdf[c], cdf[c+1]) and the rest as bisection
    probes (cdf[mid]); cdf[x] is read by then."""
    lanes = one[3].numel()
    cand_probes = int(one[3].clamp(max=topk).sum())
    bisect_probes = int(one[3].sum()) - cand_probes
    read = int((one[1] - p0).sum())
    moved = (lanes * (8 + 4 * topk + 4 + 20)  # s, ptr, cands, f[x], outputs
             + 8 * cand_probes + 4 * bisect_probes + read)
    ops = 12 * lanes + 4 * int(one[3].sum())  # per lane ~12, per probe ~4
    return (*_bound(moved, ops), moved, ops)


def _decode_bound(sym, probes, *, stream_bytes: int, cells: int,
                  index_bytes: int, predictor: bool,
                  static_table_bytes: int | None = None, cands=None):
    """The full-stream decode's bound at these inputs: ``(ms, bound_by,
    bytes moved)``, see :func:`_bound`.  Bytes: the stream bytes read once,
    ``index_bytes`` per cell (``start``, or ``base``/``wstart``/``wlen``)
    and 8 B of probe and underflow planes per cell; 4 B per symbol written;
    4 B per candidate id tried.  A static table (``static_table_bytes``) is
    read once into shared memory and costs nothing more.  Per-position or
    per-lane rows are read from device memory where the search touches
    them: per symbol 4 B for ``f[x]``, per candidate tried ``cdf[c]`` and
    ``cdf[c+1]``, 8 B per window verify, 4 B per bisection probe
    (``cdf[x]`` is read by then).  A candidate resolves a symbol at the
    first slot holding it, so the candidate probes follow from the symbols
    and the planes."""
    import torch
    n = sym.numel()
    total = int(probes.sum())
    cand = resolved = 0
    if cands is not None:
        hits = cands.clamp(0, K - 1) == sym.T[..., None].to(cands.dtype)
        hit = hits.any(-1)
        first = hits.to(torch.int32).argmax(-1) + 1
        cand = int(torch.where(hit, first, cands.shape[-1]).sum())
        resolved = int(hit.sum())
    window = n - resolved if predictor else 0
    bisect = total - cand - window
    _check(bisect >= 0, "probe breakdown is negative")
    moved = stream_bytes + cells * (index_bytes + 8) + 4 * n + 4 * cand
    if static_table_bytes is None:
        moved += 4 * n + 8 * cand + 8 * window + 4 * bisect
    else:
        moved += static_table_bytes
    ops = 12 * n + 4 * total              # per symbol ~12, per probe ~4
    return *_bound(moved, ops), moved


def chunked_decode_phase(dev, encoded):
    """B3 on the dense chunked stream and B4 straight off its packed v2
    container, at the slice's shapes with top-4 candidates."""
    import numpy as np
    import torch
    from repro_torch.core import bitstream
    from repro_torch.core.bitstream import ChunkedLanes
    from repro_torch.core.spc import FreqCdf
    from repro_torch.kernels import ops, rans_decode

    syms, tables, enc_out = encoded
    chunks = ChunkedLanes(*enc_out)
    tbl = FreqCdf(tables.freq, tables.cdf)
    cands = torch.topk(tables.freq, TOPK, dim=-1).indices.to(torch.int32)

    def b3(buf, plain=False):
        fn = (rans_decode.rans_decode_lanes_plain if plain
              else rans_decode.rans_decode_lanes)
        return fn(buf, chunks.start, tbl.freq, tbl.cdf, T, CHUNK,
                  candidates=cands)

    got, ref = b3(chunks.buf), b3(chunks.buf, plain=True)
    torch.cuda.synchronize()
    _branch("rans_decode_lanes", {"warp_rows"}, "B3 on per-lane rows")
    err = _max_abs_err(got, ref)
    _check(torch.equal(got[0], syms), "B3 lost a symbol")
    _check(int(got[2].sum()) == 0, "B3 flagged a valid stream")
    short = chunks.buf[..., :-3].contiguous()     # 3 bytes cut per cell
    got_s, ref_s = b3(short), b3(short, plain=True)
    torch.cuda.synchronize()
    _branch("rans_decode_lanes", {"warp_rows"}, "B3 truncated")
    err = max(err, _max_abs_err(got_s, ref_s))
    _check(int(got_s[2].sum()) > 0, "truncated stream not flagged")
    flags = ops.rans_decode_chunked(
        ChunkedLanes(short, chunks.start, chunks.length - 3), T, tbl, CHUNK,
        candidates=cands, exhausted_flags=True)[-1]
    _check(torch.equal(flags, got_s[2] > 0), "ops exhausted flags differ")
    print(f"B3 chunked: kernel == plain at ({LANES} lanes, T={T}, chunk "
          f"{CHUNK}, per-lane tables, top-{TOPK} candidates) and truncated "
          f"by 3 bytes per cell ({int((got_s[2] > 0).sum())} cells flagged, "
          f"{int(got_s[2].sum())} underflowing reads)", flush=True)
    b3_ms = _device_ms(lambda: b3(chunks.buf), n=10)
    b3_call_ms = _median_ms(lambda: b3(chunks.buf), repeats=30)

    blob = bitstream.pack_chunked(*chunks, chunk_size=CHUNK, n_symbols=T)
    cs = bitstream.parse_chunked(blob)
    res = ops.rans_decode_chunked(tbl=tbl, from_container=cs,
                                  candidates=cands, chunk_probes=True)
    _check(torch.equal(res[0], got[0]) and torch.equal(res[2], got[1]),
           "B4 from the container differs from B3 on the dense stream")
    planes, cap = ops.slab_planes(cs, dev)
    kw = dict(cap=cap, t_len=T, chunk_size=CHUNK, candidates=cands)

    def b4(p, plain=False):
        fn = (rans_decode.rans_decode_slab_plain if plain
              else rans_decode.rans_decode_slab)
        return fn(*p, tbl.freq, tbl.cdf, **kw)

    got4, ref4 = b4(planes), b4(planes, plain=True)
    torch.cuda.synchronize()
    _branch("rans_decode_slab", {"warp_rows"}, "B4 on per-lane rows")
    err = max(err, _max_abs_err(got4, ref4), _max_abs_err(got4, got))
    s = cs.slab.shape[0]               # tests/test_bitstream_fuzz.py's three
    poisons = {
        "offset_past_end": cs._replace(
            offset=np.full_like(cs.offset, s + 1000)),
        "length_past_window": cs._replace(
            length=np.full_like(cs.length, cs.cap + 7)),
        "both_hostile": cs._replace(
            offset=np.full_like(cs.offset, s - 1),
            length=np.full_like(cs.length, cs.cap + 3)),
    }
    flagged = {}
    for name, bad in poisons.items():
        p, _ = ops.slab_planes(bad, dev)
        g, r = b4(p), b4(p, plain=True)
        _branch("rans_decode_slab", {"warp_rows"}, f"B4 {name}")
        flags = ops.rans_decode_chunked(tbl=tbl, from_container=bad,
                                        candidates=cands,
                                        exhausted_flags=True)[-1]
        torch.cuda.synchronize()
        err = max(err, _max_abs_err(g, r))
        _check(torch.equal(flags, g[2] > 0), f"{name}: ops flags differ")
        flagged[name] = int(flags.sum())
    _check(flagged["offset_past_end"] == cs.offset.size,
           "offsets past the payload end not flagged in every cell")
    print(f"B4 slab: kernel == plain == B3 off the packed v2 container "
          f"({len(blob)} bytes), and kernel == plain on the 3 poisoned "
          f"slabs (flagged cells {flagged})", flush=True)

    ms = _device_ms(lambda: b4(planes), n=10)
    call_ms = _median_ms(lambda: b4(planes), repeats=30)
    plain_ms = _median_ms(lambda: b4(planes, plain=True), repeats=3,
                          warmup=1)
    bound_ms, bound_by, moved = _decode_bound(
        got4[0], got4[1], stream_bytes=int(cs.length.sum()),
        cells=cs.offset.size, index_bytes=12, predictor=False, cands=cands)
    print(f"B4 slab: {ms:.4f} ms kernel on the device ({call_ms:.4f} ms per "
          f"wrapper call; B3 on the dense stream {b3_ms:.4f} ms, "
          f"{b3_call_ms:.4f} ms per call), "
          f"{plain_ms:.2f} ms plain, bound {bound_ms:.6f} ms by {bound_by} "
          f"({moved} B moved); {cs.offset.size} cells each walk {CHUNK} "
          "dependent steps: latency-bound", flush=True)
    return dict(name="rans_decode_slab", route="cuda",
                source="src/repro_torch/csrc/rans_decode_lanes.cu",
                replaces="src/repro/kernels/rans_decode.py:379",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                call_ms=call_ms, b3_chunked_ms=b3_ms,
                b3_chunked_call_ms=b3_call_ms)


def fig4b_phase(dev):
    """B3 at the Fig. 4(b) point: static histogram table, each predictor;
    the probe totals are integers the JAX package also gives."""
    import torch
    from repro_torch.core.predictors import (LastValue, NeighborAverage,
                                             ZeroPredictor)
    from repro_torch.data.pipeline import image_rows
    from repro_torch.kernels import rans_decode
    from repro_torch.serve import compress

    rows = image_rows(FIG4B_LANES, FIG4B_T, seed=0)
    enc, tbl = compress.histogram_compress(rows, K)
    want = torch.as_tensor(rows, dtype=torch.int32, device=dev)
    args = (enc.buf, enc.start, tbl.freq, tbl.cdf, FIG4B_T)
    points = [("no predictor", None),
              ("NeighborAverage(4, 8)", NeighborAverage(4, 8)),
              ("NeighborAverage(2, 4)", NeighborAverage(2, 4)),
              ("LastValue(8)", LastValue(8)),
              ("ZeroPredictor(8)", ZeroPredictor(8))]
    err, totals = 0, []
    for name, pred in points:
        got = rans_decode.rans_decode_lanes(*args, predictor=pred)
        ref = rans_decode.rans_decode_lanes_plain(*args, predictor=pred)
        torch.cuda.synchronize()
        _branch("rans_decode_lanes", {"slot_table"}, f"Fig. 4(b) {name}")
        err = max(err, _max_abs_err(got, ref))
        _check(torch.equal(got[0], want) and int(got[2].sum()) == 0,
               f"Fig. 4(b) {name}: decode not exact")
        totals.append(int(got[1].sum()))
        print(f"Fig. 4(b) {name}: {totals[-1]} probes, "
              f"{totals[-1] / want.numel():.4f} probes/symbol "
              "(kernel == plain)", flush=True)
    _check(tuple(totals[:3]) == FIG4B_TOTALS,
           f"probe totals {totals[:3]} != {FIG4B_TOTALS}")
    def b3():
        return rans_decode.rans_decode_lanes(*args, predictor=points[1][1])

    ms = _device_ms(b3, n=5)
    call_ms = _median_ms(b3, repeats=10)
    print(f"Fig. 4(b): {FIG4B_LANES} lanes x {FIG4B_T} image_rows(seed=0), "
          f"totals {totals[:3]} equal BENCH_search.json's; "
          f"{totals[0] / want.numel():.4f} -> {totals[1] / want.numel():.4f}"
          f" -> {totals[2] / want.numel():.4f} probes/symbol (paper: 7.00 "
          f"-> 3.15 search steps); B3 {ms:.4f} ms on the device ({call_ms:.4f}"
          " ms per wrapper call) with NeighborAverage(4, 8) (slot-table path)",
          flush=True)
    return err, ms, call_ms


def image_phase(dev):
    """The static-table image path at 1 megapixel, end to end, then B3's
    record at its shapes."""
    import numpy as np
    import torch
    from repro_torch.core import bitstream
    from repro_torch.core.predictors import NeighborAverage
    from repro_torch.data.pipeline import synthetic_image
    from repro_torch.core.coder import default_cap
    from repro_torch.kernels import LAUNCHES, ops, rans_decode, reset_launches
    from repro_torch.serve import compress

    img = synthetic_image(IMAGE_SIDE, IMAGE_SIDE, seed=42)
    rows = img.reshape(IMAGE_LANES, -1).astype(np.int64)
    lanes, n = rows.shape
    pred = NeighborAverage(4, 8)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    reset_launches()
    (enc_c, tbl), t_coder = timed(lambda: compress.histogram_compress(rows,
                                                                      K))
    enc_k, t_enc = timed(lambda: ops.rans_encode(torch.as_tensor(
        rows, dtype=torch.int32, device=dev), tbl))
    blob = bitstream.pack(*enc_k, n_symbols=n)
    _check(bitstream.pack(*enc_c, n_symbols=n) == blob,
           "coder and B1 v1 containers differ")
    buf, start, meta = bitstream.unpack(blob)
    enc = bitstream.EncodedLanes(torch.as_tensor(buf, device=dev),
                                 torch.as_tensor(start, device=dev), None)
    (sym, avg, lp), t_dec = timed(lambda: compress.histogram_decompress(
        enc, meta.n_symbols, tbl, predictor=pred, lane_probes=True))
    launches = dict(LAUNCHES)
    _check(launches == _only(rans_encode_lanes=1, rans_decode_lanes=1),
           f"image path launch counts {launches}")
    _branch("rans_decode_lanes", {"slot_table"}, "image path")
    _check(np.array_equal(sym.cpu().numpy(), rows),
           "image round trip not exact")
    _, avg0 = compress.histogram_decompress(enc, n, tbl)
    csym, _, clp = compress.histogram_decompress(
        enc, n, tbl, predictor=pred, backend="coder", lane_probes=True)
    _check(torch.equal(csym, sym) and torch.equal(clp, lp),
           "coder backend differs from B3 on the image")
    print(f"image: {IMAGE_SIDE}x{IMAGE_SIDE} 8-bit synthetic_image(seed=42) "
          f"as {lanes} lanes x {n}: B1 and coder v1 containers "
          f"byte-identical ({len(blob)} bytes), round trip bit-exact, coder "
          f"backend equal per-lane probes; launches {launches}", flush=True)
    print(f"image: CR {rows.size / len(blob):.4f}, "
          f"{8 * len(blob) / rows.size:.4f} bits/symbol; probes/symbol "
          f"{float(avg0):.4f} baseline -> {float(avg):.4f} with "
          f"NeighborAverage(4, 8); B1 encode {rows.size / t_enc:.1f} "
          f"symbols/s ({t_enc:.4f} s), B3 decode {rows.size / t_dec:.1f} "
          f"symbols/s ({t_dec:.4f} s), coder compress "
          f"{rows.size / t_coder:.1f} symbols/s", flush=True)

    img_syms = torch.as_tensor(rows, dtype=torch.int32, device=dev)

    def b1():
        return ops.rans_encode(img_syms, tbl)

    b1_ms = _device_ms(b1, n=3, repeats=3)
    b1_call_ms = _median_ms(b1, repeats=5, warmup=1)
    b1_moved = (img_syms.numel() * 4 + 5 * K * 4
                + lanes * (default_cap(n) + 9))
    b1_bound_ms, b1_bound_by = _bound(b1_moved, img_syms.numel() * 10)
    print(f"B1 image: {b1_ms:.4f} ms kernel on the device ({b1_call_ms:.4f} "
          f"ms per wrapper call; {t_enc * 1e3:.1f} ms wall for the first "
          f"call above), bound {b1_bound_ms:.6f} ms by {b1_bound_by} "
          f"({b1_moved} B moved); {lanes} cells each walk {n} dependent "
          "steps: latency-bound", flush=True)
    args = (enc.buf, enc.start, tbl.freq, tbl.cdf, n)

    def call():
        return rans_decode.rans_decode_lanes(*args, predictor=pred)

    got = call()
    ref, plain_s = timed(lambda: rans_decode.rans_decode_lanes_plain(
        *args, predictor=pred))
    err = _max_abs_err(got, ref)
    ms = _device_ms(call, n=3, repeats=3)
    call_ms = _median_ms(call, repeats=5, warmup=1)
    bound_ms, bound_by, moved = _decode_bound(
        got[0], got[1], stream_bytes=int(enc_k.length.sum()), cells=lanes,
        index_bytes=4, predictor=True, static_table_bytes=(2 * K + 1) * 4)
    _branch("rans_decode_lanes", {"slot_table"}, "B3 image record")
    print(f"B3 image: kernel == plain; {ms:.4f} ms kernel on the device "
          f"({call_ms:.4f} ms per wrapper call), {plain_s * 1e3:.1f} ms "
          f"plain (one run), bound {bound_ms:.6f} ms by {bound_by} ({moved} "
          f"B moved, {ms / bound_ms:.0f}x); {lanes} threads each walk {n} "
          "dependent steps through the slot table: latency-bound",
          flush=True)
    return dict(name="rans_decode_lanes", route="cuda",
                source="src/repro_torch/csrc/rans_decode_lanes.cu",
                replaces="src/repro/kernels/rans_decode.py:223",
                max_abs_err=err, ms=ms, plain_ms=plain_s * 1e3,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                call_ms=call_ms), launches, dict(
                    b1_image_ms=b1_ms, b1_image_call_ms=b1_call_ms,
                    b1_image_bound_ms=b1_bound_ms)


# B3/B4 table cases beyond the main paths: (layout, K, prob_bits, zero
# frequencies, predictor, the code paths the kernel must run)
DECODE_CASES = {
    "static K=256 with zero frequencies": (
        "static", 256, 14, True, ("NeighborAverage", 4, 8),
        {"shared_bisect"}),
    "per-lane rows with zero frequencies": (
        "lane", 256, 14, True, ("LastValue", 8), {"warp_rows", "warp_bisect"}),
    "static prob_bits=16 (slot table over 48 KB)": (
        "static", 256, 16, False, ("NeighborAverage", 1, 8), {"slot_table"}),
    "static K=1000": (
        "static", 1000, 14, False, ("NeighborAverage", 16, 3),
        {"slot_table"}),
    "static K=4096": ("static", 4096, 14, False, None, {"slot_table"}),
    "static K=5000 (above the slot table's limit)": (
        "static", 5000, 14, False, ("NeighborAverage", 16, 8),
        {"warp_rows"}),
    "per-position rows K=300": (
        "perpos", 300, 14, False, ("ZeroPredictor", 8), {"warp_rows"}),
    "static K=256, window wider than the probe tables": (
        "static", 256, 14, False, ("LastValue", 40), {"warp_rows"}),
}
# two full chunks and a ragged 44-symbol tail (chunk 256 before the
# tooling phases came: the plain decodes take one step per symbol of a
# chunk)
CASE_LANES, CASE_T, CASE_CHUNK = 64, 300, 128


def decode_cases_phase(dev):
    """B3 (dense, also truncated) and B4 (off the packed container) on the
    table cases the main paths do not reach, each held against its plain
    version, with the code path each launch ran."""
    import numpy as np
    import torch
    from repro_torch.core import bitstream, predictors, spc
    from repro_torch.core.bitstream import ChunkedLanes
    from repro_torch.data.pipeline import candidate_planes
    from repro_torch.kernels import ops, rans_decode

    t0 = time.perf_counter()
    err3 = err4 = 0
    for i, (name, (layout, k, bits, zero, pcfg, want)) in enumerate(
            DECODE_CASES.items()):
        rng = np.random.default_rng(100 + i)
        shape = {"static": None, "perpos": CASE_T,
                 "lane": (CASE_T, CASE_LANES)}[layout]
        probs = rng.dirichlet(np.full(k, 0.5), size=shape).astype(np.float32)
        tt = spc.tables_from_probs(torch.as_tensor(probs), bits)
        syms = np.clip(k // 2 + np.cumsum(rng.integers(
            -3, 4, (CASE_LANES, CASE_T)), 1), 0, k - 1).astype(np.int32)
        if zero:                 # frequency 0 at four symbols, in every row
            zs = [3, 4, k // 2 - 7, k - 56]    # (static) or every 7th row
            freq = tt.freq.clone().reshape(-1, k)
            rows = slice(None, None, 1 if layout == "static" else 7)
            freq[rows, k // 2] += freq[rows][:, zs].sum(-1)
            freq[rows, zs] = 0
            tt = spc.build_tables(freq.reshape(tt.freq.shape), bits)
            for z in zs:
                syms[syms == z] = z + 2
        pred = None if pcfg is None else getattr(predictors, pcfg[0])(
            *pcfg[1:])
        gt = spc.TableSet(*(a.to(dev) for a in tt))
        gs = torch.as_tensor(syms, device=dev)
        cands = torch.as_tensor(candidate_planes(syms, k, 2, 0.5, seed=i),
                                device=dev) if i % 2 else None
        ch = ops.rans_encode_chunked(gs, gt, CASE_CHUNK)
        kw = dict(prob_bits=bits, predictor=pred, candidates=cands)
        for buf, tag in ((ch.buf, "dense"),
                         (ch.buf[..., :-3].contiguous(), "truncated")):
            got = rans_decode.rans_decode_lanes(
                buf, ch.start, gt.freq, gt.cdf, CASE_T, CASE_CHUNK, **kw)
            ref = rans_decode.rans_decode_lanes_plain(
                buf, ch.start, gt.freq, gt.cdf, CASE_T, CASE_CHUNK, **kw)
            torch.cuda.synchronize()
            _branch("rans_decode_lanes", want, f"B3 {name}, {tag}")
            err3 = max(err3, _max_abs_err(got, ref))
            if tag == "dense" and not zero:
                _check(torch.equal(got[0], gs), f"B3 {name}: not exact")
        cs = bitstream.parse_chunked(bitstream.pack_chunked(
            *ChunkedLanes(*ch), chunk_size=CASE_CHUNK, n_symbols=CASE_T))
        planes, cap = ops.slab_planes(cs, dev)
        kw4 = dict(kw, cap=cap, t_len=CASE_T, chunk_size=CASE_CHUNK)
        got = rans_decode.rans_decode_slab(*planes, gt.freq, gt.cdf, **kw4)
        ref = rans_decode.rans_decode_slab_plain(*planes, gt.freq, gt.cdf,
                                                 **kw4)
        torch.cuda.synchronize()
        _branch("rans_decode_slab", want, f"B4 {name}")
        err4 = max(err4, _max_abs_err(got, ref))
        print(f"B3/B4 case {name} ({layout}, K={k}, prob_bits={bits}, "
              f"predictor {pred}, {'top-2' if cands is not None else 'no'} "
              f"candidates): kernel == plain, dense, truncated and off the "
              f"container; paths {sorted(want)}", flush=True)
    print(f"B3/B4 cases: {len(DECODE_CASES)} tables, {CASE_LANES} lanes x "
          f"{CASE_T}, chunk {CASE_CHUNK} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    return err3, err4


def reference_check(dev):
    """The model on the card vs the same model on the CPU, small input."""
    import torch
    from repro_torch.configs.ras_pimc import SMOKE
    from repro_torch.models import decode_step, init_model, init_state

    toks = torch.randint(0, 256, (4, 8),
                         generator=torch.Generator().manual_seed(0))
    worst = 0.0
    models = [init_model(SMOKE, seed=3, device=d) for d in ("cpu", dev)]
    states = [init_state(m, 4, 8) for m in models]
    for t in range(8):
        lg = [decode_step(m, st, toks[:, t:t + 1].to(m.embedding.device), t)
              for m, st in zip(models, states)]
        _check(bool(torch.isfinite(lg[1]).all()), "non-finite logits")
        worst = max(worst, float((lg[1].cpu() - lg[0]).abs().max()))
    _check(worst <= 1e-4, f"card logits differ from CPU logits by {worst}")
    print(f"reference check: smoke-model logits, card vs CPU, 8 steps: max "
          f"abs diff {worst:.3e} (tolerance 1e-4)", flush=True)


@contextlib.contextmanager
def _plain_spc_spy():
    """Record every call of the sort-based plain SPC on a CUDA tensor in
    the block (the kernel paths must make none); yields the list of the
    calls' shapes."""
    from repro_torch.core import spc
    plain_spc, on_card = spc.quantize_probs, []

    def spy(probs, *a, **kw):
        if probs.is_cuda:
            on_card.append(tuple(probs.shape))
        return plain_spc(probs, *a, **kw)

    spc.quantize_probs = spy
    try:
        yield on_card
    finally:
        spc.quantize_probs = plain_spc


@contextlib.contextmanager
def _b6_capture():
    """Record every B6 ``spc_freq_cdf`` call on a CUDA tensor in the block:
    yields the list of ``(probs, freq, cdf)``, each tensor as the call saw
    or returned it, for holding against the plain version afterwards."""
    from repro_torch.kernels import spc_quantize
    kernel_spc, calls = spc_quantize.spc_freq_cdf, []

    def capture(probs, *a, **kw):
        f, c = kernel_spc(probs, *a, **kw)
        if probs.is_cuda:
            calls.append((probs.clone(), f, c))
        return f, c

    spc_quantize.spc_freq_cdf = capture
    try:
        yield calls
    finally:
        spc_quantize.spc_freq_cdf = kernel_spc


def main_path(dev):
    import numpy as np
    import torch
    from repro_torch.configs.ras_pimc import CONFIG
    from repro_torch.core import bitstream
    from repro_torch.data.pipeline import token_stream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import init_model
    from repro_torch.serve import compress

    model = init_model(CONFIG, seed=0, device=dev)
    tokens = token_stream(CONFIG.vocab_size, (LANES, SLICE_T), seed=0)
    # the sort-based plain SPC must not run on the card on this path
    with _plain_spc_spy() as on_card:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = compress.lm_compress_chunked(model, tokens, CHUNK,
                                          backend="kernel")
        torch.cuda.synchronize()
        t_comp = time.perf_counter() - t0
        blob = bitstream.pack_chunked(*st.chunks, chunk_size=CHUNK,
                                      n_symbols=SLICE_T)
        cs = bitstream.parse_chunked(blob)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sym, avg, lane_probes = compress.lm_decompress_chunked(
            model, cs, SLICE_T, CHUNK, backend="kernel", lane_probes=True)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        launches = dict(LAUNCHES)
    _check(launches == _only(rans_encode_lanes=1, rans_decode_step=SLICE_T,
                             spc_quantize=SLICE_T + 1),
           f"launch counts {launches}")
    _check(not on_card, f"the plain SPC ran on the card {len(on_card)} times"
           " on the kernel backend")
    _branch("rans_decode_step", {"warp_rows"}, "slice B2, last position")
    _check(np.array_equal(sym.cpu().numpy(), tokens), "round trip not exact")
    print(f"slice: {CONFIG.name} ({CONFIG.n_layers} layers, d_model "
          f"{CONFIG.d_model}), {LANES} lanes x {SLICE_T} tokens, chunk "
          f"{CHUNK}: "
          f"round trip bit-exact; launches {launches}; no plain SPC call on "
          "the card", flush=True)
    print(f"slice: bits/symbol {float(st.bits_per_symbol):.4f}, model xent "
          f"{float(st.model_xent_bits):.4f} bits, avg probes/symbol "
          f"{float(avg):.4f}, container {len(blob)} bytes", flush=True)
    print(f"slice: compress {LANES * SLICE_T / t_comp:.1f} symbols/s "
          f"({t_comp:.3f} s), decompress "
          f"{LANES * SLICE_T / t_dec:.1f} symbols/s "
          f"({t_dec:.3f} s); idle gaps not measured", flush=True)

    st_c = compress.lm_compress_chunked(model, tokens, CHUNK, backend="coder")
    blob_c = bitstream.pack_chunked(*st_c.chunks, chunk_size=CHUNK,
                                    n_symbols=SLICE_T)
    _check(blob_c == blob, "coder and kernel containers differ")
    sym_c, avg_c, lane_probes_c = compress.lm_decompress_chunked(
        model, cs, SLICE_T, CHUNK, backend="coder", lane_probes=True)
    _check(np.array_equal(sym_c.cpu().numpy(), tokens),
           "coder round trip not exact")
    _check(torch.equal(lane_probes_c, lane_probes), "per-lane probes differ")
    print("slice: coder backend on the card: byte-identical container, "
          "equal per-lane probes", flush=True)
    return launches, dict(model=model, tokens=tokens, cs=cs, blob=blob,
                          lane_probes=lane_probes, t_dec=t_dec)


def two_pass_phase(slice_run):
    """The two-pass decode of the slice's container: pass 1 is the coder
    scan collecting tables and candidates, pass 2 one B4 launch."""
    import numpy as np
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve import compress

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sym, _, lane_probes = compress.lm_decompress_chunked(
        slice_run["model"], slice_run["cs"], SLICE_T, CHUNK,
        backend="two_pass", lane_probes=True)
    torch.cuda.synchronize()
    t_two = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    _check(launches == _only(rans_decode_slab=1),
           f"two-pass launch counts {launches}")
    _branch("rans_decode_slab", {"warp_rows"}, "two-pass B4")
    _check(np.array_equal(sym.cpu().numpy(), slice_run["tokens"]),
           "two-pass round trip not exact")
    _check(torch.equal(lane_probes, slice_run["lane_probes"]),
           "two-pass per-lane probes differ from the fused decode's")
    print(f"two-pass: round trip bit-exact from the ContainerSlab, per-lane "
          f"probes equal the fused decode's; launches {launches}; "
          f"{LANES * SLICE_T / t_two:.1f} symbols/s ({t_two:.3f} s) against "
          f"the fused decode's "
          f"{LANES * SLICE_T / slice_run['t_dec']:.1f} symbols/s "
          "in this run", flush=True)
    return launches

def _stream_hbm_bytes(lanes: int, t: int, chunk: int | None,
                      cap: int) -> tuple[int, int]:
    """The analytic encode-side stream traffic of the records and the fused
    datapath, ``benchmarks/bench_speed._encode_stream_hbm_bytes``'s formula:
    the records path writes ``(rows, 2, lanes)`` byte and mask planes and
    the compaction reads both back before writing the packed buffer; the
    fused path writes the packed buffer and three geometry planes once."""
    chunk = t if chunk is None else min(chunk, t)
    n_chunks = -(-t // chunk)
    rec_planes = n_chunks * chunk * 2 * lanes * 2
    packed = n_chunks * lanes * cap
    return 2 * rec_planes + packed, packed + 3 * n_chunks * lanes * 4


def _records_bound(rec, n_symbols: int, table_bytes: int):
    """B5's bound: 4 B per symbol read, the table (``table_bytes``: rows
    gathered per step, or a static table once), every record plane written
    once and the states; ~10 integer operations per step."""
    moved = (4 * n_symbols + table_bytes + rec[0].numel() + rec[1].numel()
             + 4 * rec[2].numel())
    return (*_bound(moved, 10 * n_symbols), moved)


def records_phase(dev, encoded):
    """B5 at B1's phase inputs: records -> compaction equals the fused
    encode byte for byte, kernel == plain on all three planes."""
    import torch
    from repro_torch.core.coder import default_cap
    from repro_torch.kernels import LAUNCHES, ops, rans_encode, reset_launches

    t0 = time.perf_counter()
    syms, tables, fused = encoded
    cap, small = default_cap(CHUNK), default_cap(CHUNK) // 3
    reset_launches()
    rec = ops.rans_encode_records(syms, tables, CHUNK)
    enc = ops.compact_records(*rec, cap)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    _check(launches == _only(rans_encode_records=1),
           f"records launch counts {launches}")
    err = _max_abs_err(enc, fused)
    fused_small = rans_encode.rans_encode_lanes(syms, tables, small, CHUNK)
    _check(bool(fused_small[3].any()), "cap // 3 did not overflow")
    for t_block in (None, RECORDS_T_BLOCK):
        got = (rec if t_block is None else
               rans_encode.rans_encode_records(syms, tables, CHUNK, t_block))
        ref = rans_encode.rans_encode_records_plain(syms, tables, CHUNK,
                                                    t_block)
        torch.cuda.synchronize()
        err = max(err, _max_abs_err(got, ref))
        for c, want in ((cap, fused), (small, fused_small)):
            err = max(err, _max_abs_err(ops.compact_records(*got, c), want))
    padded = got[0].shape[1]
    _check(padded == -(-CHUNK // RECORDS_T_BLOCK) * RECORDS_T_BLOCK,
           f"padded chunk {padded}")
    for plane in got[:2]:
        _check(not bool(plane[:-1, CHUNK:].any())
               and not bool(plane[-1, T % CHUNK:].any()),
               "t_block padding rows are not zero")
    print(f"B5 records: kernel == plain on bytes, mask and states at "
          f"({LANES} lanes, T={T}, chunk {CHUNK}, per-lane tables) with "
          f"t_block None and {RECORDS_T_BLOCK} (padded chunk {padded}); "
          f"compact_records == B1 byte for byte at cap {cap} and at cap "
          f"{small} ({int(fused_small[3].sum())} overflowed cells); "
          f"launches {launches}", flush=True)
    nodes = _graph_nodes(lambda: rans_encode.rans_encode_records(
        syms, tables, CHUNK))
    _check(nodes == ["KERNEL"], f"B5's call runs {nodes} on the device, not "
           "one kernel")
    n_edges = 0
    for name, esyms, etbl, chunk in _encode_edges(dev):
        for t_block in (None, 7):
            got = rans_encode.rans_encode_records(esyms, etbl, chunk,
                                                  t_block)
            err = max(err, _max_abs_err(got, rans_encode.
                                        rans_encode_records_plain(
                                            esyms, etbl, chunk, t_block)))
            n_edges += 1
        ecap = default_cap(chunk)
        for c in (ecap, 3):        # the records compact to B1's streams
            err = max(err, _max_abs_err(
                ops.compact_records(*got, c),
                rans_encode.rans_encode_lanes(esyms, etbl, c, chunk)))
    torch.cuda.synchronize()
    print(f"B5 records: one kernel node per call; kernel == plain on "
          f"{n_edges} edge cases (the B1 phase's, t_block None and 7), "
          "compacted == B1 at the default cap and cap 3", flush=True)

    def b5():
        return rans_encode.rans_encode_records(syms, tables, CHUNK)

    def b5_compact():
        return ops.compact_records(*b5(), cap)

    def b1():
        return rans_encode.rans_encode_lanes(syms, tables, cap, CHUNK)

    ms = _device_ms(b5, n=10)
    call_ms = _median_ms(b5, repeats=30)
    b1_ms = _device_ms(b1, n=10)
    b1_call_ms = _median_ms(b1, repeats=30)
    compact_call_ms = _median_ms(b5_compact, repeats=30)
    plain_ms = _median_ms(lambda: rans_encode.rans_encode_records_plain(
        syms, tables, CHUNK), repeats=3, warmup=1)
    bound_ms, bound_by, moved = _records_bound(rec, LANES * T,
                                               LANES * T * 5 * 4)
    rec_bytes, fused_bytes = _stream_hbm_bytes(LANES, T, CHUNK, cap)
    print(f"B5 records: {ms:.4f} ms kernel on the device ({call_ms:.4f} ms "
          f"per wrapper call), {compact_call_ms:.4f} ms per call with "
          f"compact_records, beside B1 {b1_ms:.4f} ms on the device "
          f"({b1_call_ms:.4f} ms per call); {plain_ms:.2f} ms plain; bound "
          f"{bound_ms:.6f} ms by {bound_by} ({moved} B moved); analytic "
          f"stream bytes: records {rec_bytes}, fused {fused_bytes} "
          f"({rec_bytes / fused_bytes:.2f}x); latency-bound like B1 "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return dict(name="rans_encode_records", route="cuda",
                source="src/repro_torch/csrc/rans_encode.cu",
                replaces="src/repro/kernels/rans_encode.py:396",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                call_ms=call_ms, compact_call_ms=compact_call_ms,
                b1_ms=b1_ms, launches=launches["rans_encode_records"])


def fig4a_phase(dev):
    """The paper's Fig. 4(a) protocol: the scalar oracle and the Python
    baseline, the multi-lane coder and the kernels, on the same CDFs with
    identical bitstreams; microseconds per symbol on this card and host."""
    import numpy as np
    import torch
    from repro_torch.core import coder, golden, python_baseline, spc
    from repro_torch.data.pipeline import image_rows
    from repro_torch.kernels import (LAUNCHES, ops, rans_decode, rans_encode,
                                     reset_launches)

    t_phase = time.perf_counter()
    rows = image_rows(FIG4A_LANES, FIG4A_T, seed=0)
    n = rows.size
    host_tbl = spc.tables_from_counts_np(np.bincount(rows.ravel(),
                                                     minlength=K))
    f, cdf = host_tbl.freq.numpy(), host_tbl.cdf.numpy()
    tbl = spc.TableSet(*(a.to(dev) for a in host_tbl))
    syms = torch.as_tensor(rows, dtype=torch.int32, device=dev)

    pr = python_baseline.PyRans(f, cdf)
    py_syms = [int(x) for x in rows.ravel()[:FIG4A_PY]]
    t0 = time.perf_counter()
    blob = pr.encode(py_syms)
    py_enc = (time.perf_counter() - t0) / len(py_syms) * 1e6
    t0 = time.perf_counter()
    out = pr.decode(blob, len(py_syms))
    py_dec = (time.perf_counter() - t0) / len(py_syms) * 1e6
    _check(out == py_syms, "PyRans round trip not exact")
    lane0 = golden.encode(rows[0], f, cdf)
    _check(lane0 == pr.encode([int(x) for x in rows[0]]),
           "golden and PyRans streams differ on lane 0")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) / n * 1e6

    def b5():
        b, m, st = ops.rans_encode_records(syms, tbl)
        return coder.chunk_encoded(ops.compact_records(b, m, st,
                                                       coder.default_cap(
                                                           FIG4A_T)), 0)

    reset_launches()
    encs = {}
    encs["coder.encode"], c_enc = timed(lambda: coder.encode(syms, tbl))
    encs["coder.encode_records"], r_enc = timed(
        lambda: coder.encode_records(syms, tbl))
    encs["B1"], _ = timed(lambda: ops.rans_encode(syms, tbl))
    encs["B5 + compact_records"], _ = timed(b5)
    ref = encs["coder.encode"]
    (dec, _), c_dec = timed(lambda: coder.decode(ref, FIG4A_T, tbl))
    (dec_lut, _), c_lut = timed(lambda: coder.decode(ref, FIG4A_T, tbl,
                                                     use_lut=True))
    (dec_b3, _), _ = timed(lambda: ops.rans_decode(encs["B1"], FIG4A_T, tbl))
    launches = dict(LAUNCHES)
    _branch("rans_decode_lanes", {"slot_table"}, "Fig. 4(a) B3")
    _check(launches == _only(rans_encode_lanes=1, rans_encode_records=1,
                             rans_decode_lanes=1),
           f"Fig. 4(a) launch counts {launches}")
    for name, enc in encs.items():
        _check(not bool(enc.overflow.any()), f"{name} overflowed")
        s0, l0 = int(enc.start[0]), int(enc.length[0])
        _check(bytes(enc.buf[0, s0:s0 + l0].cpu().numpy()) == lane0,
               f"lane 0 of {name} differs from golden.encode")
        _max_abs_err(enc, ref)
    for name, d in (("coder.decode", dec), ("coder.decode(use_lut=True)",
                                            dec_lut), ("B3", dec_b3)):
        _check(np.array_equal(d.cpu().numpy(), rows), f"{name} not exact")
    print(f"Fig. 4(a): {FIG4A_LANES} lanes x {FIG4A_T} image_rows(seed=0), "
          f"static histogram table: golden == PyRans == lane 0 of "
          f"{', '.join(encs)} ({len(lane0)} bytes); all lanes byte-identical "
          f"across them; coder.decode, its LUT and B3 bit-exact; PyRans round "
          f"trip exact on {FIG4A_PY} symbols; launches {launches}",
          flush=True)

    b1_ms = _device_ms(lambda: ops.rans_encode(syms, tbl), n=5)
    b5_ms = _device_ms(lambda: rans_encode.rans_encode_records(syms, tbl),
                       n=5)
    b5c_ms = _median_ms(b5, repeats=10)
    b1_enc = encs["B1"]
    def b3():
        return rans_decode.rans_decode_lanes(b1_enc.buf, b1_enc.start,
                                             tbl.freq, tbl.cdf, FIG4A_T)

    b3_ms = _device_ms(b3, n=3, repeats=3)
    b3_call_ms = _median_ms(b3, repeats=10)
    per = {"encode": [("coder.encode", c_enc),
                      ("coder.encode_records", r_enc),
                      ("B1 kernel", b1_ms * 1e3 / n),
                      ("B5 kernel", b5_ms * 1e3 / n),
                      ("B5 + compact_records per call", b5c_ms * 1e3 / n)],
           "decode": [("coder.decode", c_dec),
                      ("coder.decode(use_lut=True)", c_lut),
                      ("B3 kernel", b3_ms * 1e3 / n)]}
    base = {"encode": py_enc, "decode": py_dec}
    for side, paper in (("encode", 121.2), ("decode", 70.9)):
        row = ", ".join(f"{name} {us:.6f} us ({base[side] / us:.1f}x)"
                        for name, us in per[side])
        print(f"Fig. 4(a) {side}: PyRans {base[side]:.4f} us/symbol on the "
              f"host; {row}; paper {paper}x (RTL simulation against an "
              "Apple M4 Python baseline; these are the H100 and its host)",
              flush=True)
    bound_ms, bound_by, moved = _records_bound(
        rans_encode.rans_encode_records(syms, tbl), n, 5 * K * 4)
    print(f"Fig. 4(a): B5 {b5_ms:.4f} ms on the device at this point, bound "
          f"{bound_ms:.6f} ms by {bound_by} ({moved} B moved); "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    print(f"Fig. 4(a): B3 {b3_ms:.4f} ms on the device ({b3_call_ms:.4f} ms "
          "per wrapper call, slot-table path)", flush=True)
    return dict(b5_fig4a_ms=b5_ms, b1_fig4a_ms=b1_ms, b3_fig4a_ms=b3_ms,
                b3_fig4a_call_ms=b3_call_ms, b5_fig4a_bound_ms=bound_ms)


def _spc_bound(b: int, k: int, in_bytes: int = 4, cdf: bool = False):
    """B6's bound: ``in_bytes`` in and 4 B out per entry (4 more per entry
    with the CDF rows); K * ceil(log2 K) compares per row (the work of a
    sort-based ranking, not the kernel's K**2)."""
    moved = b * k * (in_bytes + 4) + (4 * b * (k + 1) if cdf else 0)
    return (*_bound(moved, b * k * math.ceil(math.log2(k))), moved)


def spc_phase(dev):
    """B6 at bench_spc.run's point, at one decoded position of the slice
    (128 x 256, BF16, with the CDF rows) and on the slice's whole
    per-position table batch (B1's phase probabilities as 128,000 x 256),
    each in float32 and BF16."""
    import numpy as np
    import torch
    from repro_torch.core import spc
    from repro_torch.kernels import LAUNCHES, ops, reset_launches
    from repro_torch.kernels import spc_quantize

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    point = torch.as_tensor(rng.dirichlet(np.full(SPC_POINT[1], 0.5),
                                          size=SPC_POINT[0]),
                            dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)     # encode_phase's
    logits = torch.randn((T, LANES, K), generator=gen, device=dev) * 3.0
    full16 = spc.store_bf16(torch.softmax(logits, -1)).reshape(T * LANES, K)
    del logits
    err, runs = 0, {}
    for name, probs in (("bench_spc point", point),
                        ("slice position", full16[:LANES]),
                        ("slice batch", full16.to(torch.float32)),
                        ("slice batch bf16", full16)):
        got = spc_quantize.spc_quantize(probs)
        plain = spc_quantize.spc_quantize_plain(probs)
        want = spc.tables_from_probs(probs)
        fc = spc_quantize.spc_freq_cdf(probs)
        fc_plain = spc.freq_cdf_from_probs(probs)
        torch.cuda.synchronize()
        err = max(err, _max_abs_err([got], [plain]),
                  _max_abs_err([got], [want.freq]),
                  _max_abs_err(fc, fc_plain),
                  _max_abs_err(fc, (want.freq, want.cdf)))
        reset_launches()
        tables = ops.spc_quantize_tables(probs)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        _check(launches == _only(spc_quantize=1),
               f"spc_quantize_tables launch counts {launches}")
        err = max(err, _max_abs_err(tables, want))
        if name == "bench_spc point":       # the card's tables == the CPU's
            err = max(err, _max_abs_err(
                tables, spc.tables_from_probs(probs.cpu())))
        b, k = probs.shape
        in_bytes = probs.element_size()
        # the position's call is the fused decode's: frequencies and CDF
        with_cdf = name == "slice position"
        fn = spc_quantize.spc_freq_cdf if with_cdf else \
            spc_quantize.spc_quantize
        plain_fn = spc.freq_cdf_from_probs if with_cdf else \
            spc_quantize.spc_quantize_plain
        ms = _device_ms(lambda: fn(probs), n=20 if b <= 256 else 5)
        call_ms = _median_ms(lambda: fn(probs), repeats=20)
        plain_ms = _median_ms(lambda: plain_fn(probs), repeats=5)
        bound_ms, bound_by, moved = _spc_bound(b, k, in_bytes, with_cdf)
        print(f"B6 SPC {name} ({b} x {k}, {probs.dtype}): kernel == "
              f"spc_quantize_plain == tables_from_probs(...).freq, "
              f"spc_freq_cdf == freq_cdf_from_probs, ops.spc_quantize_tables"
              f" == tables_from_probs on every plane; launches {launches}; "
              f"{'spc_freq_cdf' if with_cdf else 'spc_quantize'} "
              f"{ms:.4f} ms kernel on the device ({call_ms:.4f} ms per "
              f"call, {ms * 1e3 / b:.4f} us per table), {plain_ms:.4f} ms "
              f"plain, bound {bound_ms:.6f} ms by {bound_by} ({moved} B "
              "moved)", flush=True)
        runs[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, call_ms=call_ms)
    print(f"B6 SPC: {time.perf_counter() - t0:.1f} s", flush=True)
    # the record is the compress side's call (the BF16 slice batch); the
    # other points ride along
    return dict(name="spc_quantize", route="cuda",
                source="src/repro_torch/csrc/spc_quantize.cu",
                replaces="src/repro/kernels/spc_quantize.py:72",
                max_abs_err=err, library_ms=None,
                **runs["slice batch bf16"],
                f32_batch_ms=runs["slice batch"]["ms"],
                position_freq_cdf_ms=runs["slice position"]["ms"],
                position_freq_cdf_call_ms=runs["slice position"]["call_ms"],
                position_freq_cdf_plain_ms=runs["slice position"]["plain_ms"],
                point_ms=runs["bench_spc point"]["ms"])


# --- the batching engine (slice 4) ---------------------------------------

ENGINE_SLOTS, ENGINE_MAX_LEN = 4, 1024        # 4 slots x 128 lanes = 512 rows
# the engine phase's requests: a full chunk and a ragged 44-token tail (the
# slice's 1,000 tokens took the phase past 180 s of the script's limit)
ENGINE_T = 300
C3_STEPS = 8
C4_SLOTS, C4_WARM, C4_RAGGED = 2, 8, (172, 100)   # (row, its n_valid)
SHORT_T = 16                                  # the engine's short requests
SERVE_POINT = dict(streams=16, slots=4, lanes=2, n_symbols=64, chunk=16,
                   rate_hz=200.0, seed=0)     # bench_serve.run's point


def _clone_state(st):
    return type(st)(st.k.clone(), st.v.clone(), st.length)


def row_invariance_phase(dev, model):
    """C3 at full width, before any scheduler code runs: why the engine
    calls the model once per slot, on a state of the request's own ring
    (``serve/engine.py``).  ``ENGINE_SLOTS`` slots of 128 rows, each
    stepped alone over ``C3_STEPS`` steps (the engine's call), against the
    same rows inside one plain 512-row call; beside it a batched GEMM of
    the slots against each 128-row GEMM, and 128 rows under a ring of
    ``C3_STEPS`` against the same under a ring of ``T``.  Each difference
    is printed; every logit must be finite."""
    import torch
    from repro_torch.data.pipeline import token_stream
    from repro_torch.models import decode_step, init_state

    t0 = time.perf_counter()
    rows = ENGINE_SLOTS * LANES
    toks = torch.as_tensor(token_stream(K, (rows, C3_STEPS), seed=5),
                           device=dev)
    plain = init_state(model, rows, T)
    alone = [init_state(model, LANES, T) for _ in range(ENGINE_SLOTS)]
    plain_diff = 0.0
    for t in range(C3_STEPS):
        lg_plain = decode_step(model, plain, toks[:, t:t + 1], t)
        for s in range(ENGINE_SLOTS):
            r = slice(s * LANES, (s + 1) * LANES)
            lg = decode_step(model, alone[s], toks[r, t:t + 1], t)
            _check(bool(torch.isfinite(lg).all()),
                   f"C3: slot {s} logits not finite at step {t}")
            plain_diff = max(plain_diff, float(
                (lg_plain[r] - lg).abs().max()))
    with torch.no_grad():
        x = model.embedding[toks[:, 0]]
        w = model.blocks[0].attn.wq.reshape(x.shape[1], -1)
        bmm = torch.bmm(x.view(ENGINE_SLOTS, LANES, -1),
                        w.expand(ENGINE_SLOTS, *w.shape))
        bmm_diff = max(float((bmm[s] - x[s * LANES:(s + 1) * LANES] @ w)
                             .abs().max()) for s in range(ENGINE_SLOTS))
    short, ring_diff = init_state(model, LANES, C3_STEPS), 0.0
    long_ = init_state(model, LANES, T)
    for t in range(C3_STEPS):
        a = decode_step(model, short, toks[:LANES, t:t + 1], t)
        b = decode_step(model, long_, toks[:LANES, t:t + 1], t)
        ring_diff = max(ring_diff, float((a - b).abs().max()))
    torch.cuda.synchronize()
    for name, d in (("plain", plain_diff), ("bmm", bmm_diff),
                    ("ring", ring_diff)):
        _check(math.isfinite(d), f"C3: the {name} difference is not finite")
    print(f"C3 row invariance: over {C3_STEPS} steps the plain {rows}-row "
          f"call differs from {ENGINE_SLOTS} x {LANES} rows stepped alone "
          f"by up to {plain_diff:.3e} (cuBLAS's kernel for M={rows} orders "
          f"the sums otherwise), a torch.bmm of {ENGINE_SLOTS} x {LANES} "
          f"rows differs from each {LANES}-row GEMM by up to "
          f"{bmm_diff:.3e}, and {LANES} rows under a ring of {C3_STEPS} "
          f"differ from the same under a ring of {T} by up to "
          f"{ring_diff:.3e}: the engine calls each slot alone on a state of "
          f"its request's ring; {time.perf_counter() - t0:.1f} s",
          flush=True)
    return plain_diff


def prefill_phase(dev, model):
    """C4 at full width: one ``prefill_chunk`` over a CHUNK-position chunk
    (pos0 = C4_WARM > 0, one ragged row) of C4_SLOTS x 128 rows against
    CHUNK ``decode_step`` calls: bitwise on every live logit and on the
    whole cache but the ragged row's clamped slot (which the step path
    writes and the next chunk's first step overwrites).  A GEMM over all
    B x S positions is printed beside it: that is what the per-position
    GEMMs replace."""
    import torch
    from repro_torch.data.pipeline import token_stream
    from repro_torch.models import decode_step, init_state, prefill_chunk

    t0 = time.perf_counter()
    rows = C4_SLOTS * LANES
    toks = torch.as_tensor(token_stream(K, (rows, C4_WARM + CHUNK), seed=6),
                           device=dev)
    step = init_state(model, rows, T)
    for t in range(C4_WARM):
        decode_step(model, step, toks[:, t:t + 1], t)
    pf = _clone_state(step)
    nv = torch.full((rows,), CHUNK, dtype=torch.int64, device=dev)
    row, n_r = C4_RAGGED
    nv[row] = n_r
    pos0 = torch.full((rows,), C4_WARM, dtype=torch.int64, device=dev)
    t1 = time.perf_counter()
    ref = torch.stack([decode_step(model, step,
                                   toks[:, C4_WARM + t:C4_WARM + t + 1],
                                   pos0 + torch.clamp(nv, max=t))
                       for t in range(CHUNK)], 1)
    torch.cuda.synchronize()
    t_steps = time.perf_counter() - t1
    t1 = time.perf_counter()
    lg = prefill_chunk(model, pf, toks[:, C4_WARM:], pos0, nv)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t1
    live = torch.arange(CHUNK, device=dev)[None] < nv[:, None]
    _check(torch.equal(lg[live], ref[live]), "C4: prefill logits differ "
           "from the step path's")
    others = torch.ones(rows, dtype=torch.bool, device=dev)
    others[row] = False
    keep = torch.ones(pf.k.shape[2], dtype=torch.bool, device=dev)
    keep[C4_WARM + n_r] = False
    for a, b in ((pf.k, step.k), (pf.v, step.v)):
        _check(torch.equal(a[:, others], b[:, others])
               and torch.equal(a[:, row][:, keep], b[:, row][:, keep]),
               "C4: prefill cache differs from the step path's")
    with torch.no_grad():
        x = model.embedding[toks[:, C4_WARM:]].transpose(0, 1).contiguous()
        d = model.cfg.d_model
        w = model.blocks[0].attn.wq.reshape(d, -1)
        whole = x.reshape(-1, d) @ w
        per = torch.stack([x[t] @ w for t in range(CHUNK)])
        gemm_diff = float((whole - per.reshape(whole.shape)).abs().max())
    print(f"C4 prefill == step: prefill_chunk over {CHUNK} positions of "
          f"{rows} rows (pos0 {C4_WARM}, row {row} ragged at n_valid {n_r})"
          f" bitwise equal to {CHUNK} decode_steps on live logits and the "
          f"cache; prefill {t_prefill:.3f} s, steps {t_steps:.3f} s; one "
          f"GEMM over all {rows * CHUNK} positions differs from {rows}-row "
          f"GEMMs by up to {gemm_diff:.3e}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return dict(prefill_s=t_prefill, steps_s=t_steps, gemm_diff=gemm_diff)


def _pack(chunks, chunk, n, bits=None):
    from repro_torch.core import bitstream
    from repro_torch.core import constants as C
    return bitstream.pack_chunked(*chunks, chunk_size=chunk, n_symbols=n,
                                  prob_bits=bits or C.PROB_BITS)


def bench_serve_phase(dev, model):
    """``benchmarks/bench_serve.py``'s protocol at its point: the same
    seeded Poisson compress workload through a serial one-request-at-a-time
    server (``lm_compress_chunked(backend="kernel")`` + ``pack_chunked``,
    arrivals respected) and through ``BatchEngine(step_backend="kernel")``
    with wall-clock admission; every engine blob equals the serial one."""
    import numpy as np
    from repro_torch.data.pipeline import token_stream
    from repro_torch.serve import compress
    from repro_torch.serve.engine import BatchEngine

    p = SERVE_POINT
    t_phase = time.perf_counter()
    rng = np.random.default_rng(p["seed"])
    arrivals = np.cumsum(rng.exponential(1.0 / p["rate_hz"],
                                         size=p["streams"]))
    data = [token_stream(K, (p["lanes"], p["n_symbols"]), seed=100 + i)
            for i in range(p["streams"])]

    def serial_blob(toks):
        st = compress.lm_compress_chunked(model, toks, p["chunk"],
                                          backend="kernel")
        return _pack(st.chunks, p["chunk"], p["n_symbols"])

    def engine():
        return BatchEngine(model, slots=p["slots"], lanes=p["lanes"],
                           chunk_size=p["chunk"], max_len=p["n_symbols"],
                           step_backend="kernel")

    serial_blob(data[0])                  # warm both servers' shapes
    warm = engine()
    warm.submit_compress(data[0])
    warm.run(clock="wall")
    s_blobs, s_lat = [], []
    t0 = time.perf_counter()
    for toks, arr in zip(data, arrivals):
        gap = arr - (time.perf_counter() - t0)
        if gap > 0:
            time.sleep(gap)
        s_blobs.append(serial_blob(toks))
        s_lat.append((time.perf_counter() - t0) - arr)
    s_wall = time.perf_counter() - t0
    eng = engine()
    rids = [eng.submit_compress(t, arrival=float(a))
            for t, a in zip(data, arrivals)]
    t0 = time.perf_counter()
    res = eng.run(clock="wall")
    e_wall = time.perf_counter() - t0
    e_lat = []
    for rid, arr, blob in zip(rids, arrivals, s_blobs):
        _check(res[rid].ok, f"bench_serve request {rid}: {res[rid].error}")
        _check(res[rid].blob == blob, f"bench_serve request {rid}: engine "
               "blob differs from the serial path's")
        e_lat.append(res[rid].completed_at - arr)
    n = p["streams"]
    out = dict(serial_streams_per_s=n / s_wall,
               engine_streams_per_s=n / e_wall,
               speedup=s_wall / e_wall,
               serial_p50_s=float(np.percentile(s_lat, 50)),
               serial_p99_s=float(np.percentile(s_lat, 99)),
               engine_p50_s=float(np.percentile(e_lat, 50)),
               engine_p99_s=float(np.percentile(e_lat, 99)),
               prefill_cycles=eng.prefill_cycles,
               served=dict(data=data, arrivals=arrivals,
                           blobs=[res[rid].blob for rid in rids]))
    print(f"bench_serve point ({n} streams x {p['lanes']} lanes x "
          f"{p['n_symbols']} symbols, chunk {p['chunk']}, {p['slots']} slots,"
          f" Poisson {p['rate_hz']:.0f} Hz seed {p['seed']}): all {n} engine "
          f"blobs byte-identical to the serial path's; engine "
          f"{out['engine_streams_per_s']:.3f} streams/s against serial "
          f"{out['serial_streams_per_s']:.3f} ({out['speedup']:.3f}x); "
          f"latency p50/p99 engine {out['engine_p50_s']:.4f} / "
          f"{out['engine_p99_s']:.4f} s, serial {out['serial_p50_s']:.4f} / "
          f"{out['serial_p99_s']:.4f} s; {out['prefill_cycles']} prefill "
          f"cycles; {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def _cut(blob, cut):
    """The same container with ``cut`` bytes cut from each cell's end."""
    from repro_torch.core import bitstream
    cs = bitstream.parse_chunked(blob)
    ch = bitstream.slab_to_chunked(cs, "cpu")
    return bitstream.pack_chunked(ch.buf[..., :-cut], ch.start,
                                  ch.length - cut,
                                  chunk_size=cs.meta.chunk_size,
                                  n_symbols=cs.meta.n_symbols)


def _busy_share(fn):
    """Run ``fn`` under ``torch.profiler``, tracing the card only (the host
    side's events would multiply the trace): ``(result, wall ms, device
    busy ms)``, busy being the kernels' summed self device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy_ms = sum(dev_us(e) for e in prof.key_averages()) / 1e3
    return out, wall_ms, busy_ms


def engine_phase(dev, model):
    """The engine at full width: 4 slots x 128 lanes, ``ENGINE_T``-token
    requests, chunk ``CHUNK``, the kernel step backend, every cycle's device
    half under ``set_sync_debug_mode("error")``.

    Run A compresses 4 streams (seeds 0-3); run B
    decompresses the 4 blobs with 2 new SHORT_T-symbol compress requests
    queued behind them.  Launch counters are reset before A and read after
    B, and the sort-based plain SPC must not run on the card.  Then, on
    the 2 short blobs: one 4-slot decompress cycle under ``torch.profiler``
    (the device-busy share) with a container cut 3 bytes short per cell
    beside valid neighbours, and the coder step backend on decompress and
    compress requests."""
    import numpy as np
    import torch
    from repro_torch.core import bitstream, coder
    from repro_torch.data.pipeline import token_stream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve import compress
    from repro_torch.serve.engine import BatchEngine

    t_phase = time.perf_counter()
    toks = [token_stream(K, (LANES, ENGINE_T), seed=s)
            for s in range(ENGINE_SLOTS)]
    short = [token_stream(K, (LANES, SHORT_T), seed=10 + i) for i in (0, 1)]
    ref_blob, ref_probes = [], []
    t0 = time.perf_counter()
    for t in toks + short:
        n = t.shape[1]
        ref_blob.append(_pack(compress.lm_compress_chunked(
            model, t, CHUNK, backend="kernel").chunks, CHUNK, n))
        ref_probes.append(compress.lm_decompress_chunked(
            model, bitstream.parse_chunked(ref_blob[-1]), n, CHUNK,
            backend="kernel", lane_probes=True)[2].cpu().numpy())
    s_blob, s_probes = ref_blob[ENGINE_SLOTS:], ref_probes[ENGINE_SLOTS:]
    t_refs = time.perf_counter() - t0

    def engine(backend="kernel"):
        eng = BatchEngine(model, slots=ENGINE_SLOTS, lanes=LANES,
                          chunk_size=CHUNK, max_len=ENGINE_MAX_LEN,
                          topk=TOPK, step_backend=backend)
        eng.check_sync = backend == "kernel"
        return eng

    n_cyc = -(-ENGINE_T // CHUNK)
    with _plain_spc_spy() as on_card:
        reset_launches()
        eng = engine()
        rids = [eng.submit_compress(t) for t in toks]
        t0 = time.perf_counter()
        res = eng.run(clock="wall")
        t_comp = time.perf_counter() - t0
        pf_a = eng.prefill_cycles
        blobs = [res[r].blob for r in rids]
        for i, r in enumerate(rids):
            _check(res[r].ok and blobs[i] == ref_blob[i],
                   f"engine compress {i}: blob differs from "
                   "lm_compress_chunked's")
        eng = engine()
        dec = [eng.submit_decompress(b) for b in blobs]
        comp = [eng.submit_compress(t) for t in short]
        t0 = time.perf_counter()
        res = eng.run(clock="wall")
        t_b = time.perf_counter() - t0
        launches = dict(LAUNCHES)
    # A: one B6 batch per prefill cycle, B1 per slot and cycle; B: B2 and
    # B6 per decode step, then one prefill cycle of the 2 short requests
    want = _only(rans_encode_lanes=ENGINE_SLOTS * n_cyc + 2,
                 rans_decode_step=ENGINE_T,
                 spc_quantize=n_cyc + ENGINE_T + 1)
    _check(launches == want, f"engine launch counts {launches}, expected "
           f"{want}")
    _check(not on_card, f"the plain SPC ran on the card {len(on_card)} "
           "times in the engine")
    t_dec = max(res[r].completed_at for r in dec)
    for i, r in enumerate(dec):
        _check(res[r].ok, f"engine decompress {i}: {res[r].error}")
        _check(np.array_equal(res[r].tokens, toks[i]),
               f"engine decompress {i}: tokens not exact")
        _check(np.array_equal(res[r].lane_probes, ref_probes[i]),
               f"engine decompress {i}: probes differ from "
               "lm_decompress_chunked's")
    for i, r in enumerate(comp):
        _check(res[r].ok and res[r].blob == s_blob[i],
               f"short compress {i} behind decompress traffic: blob differs "
               "from lm_compress_chunked's")
    _check(pf_a == n_cyc and eng.prefill_cycles == 1,
           f"prefill cycles {pf_a}, {eng.prefill_cycles}")
    syms = ENGINE_SLOTS * LANES * ENGINE_T
    print(f"engine: {ENGINE_SLOTS} slots x {LANES} lanes x {ENGINE_T} "
          f"tokens, chunk {CHUNK}: {ENGINE_SLOTS} blobs byte-identical to "
          f"lm_compress_chunked's ({pf_a} prefill cycles), decompressed "
          "exactly with per-lane probes equal to lm_decompress_chunked's, "
          f"2 new {SHORT_T}-symbol compress requests behind them "
          f"byte-identical; launches {launches}; no plain SPC call on the "
          f"card; no host sync inside a cycle; single-request references "
          f"{t_refs:.1f} s", flush=True)
    print(f"engine: compress {syms / t_comp:.1f} symbols/s ({t_comp:.3f} s, "
          f"prefill), decompress {syms / t_dec:.1f} symbols/s ({t_dec:.3f} "
          f"s); whole run B {t_b:.3f} s", flush=True)

    eng = engine()
    rbad = eng.submit_decompress(_cut(s_blob[0], 3))
    rd = [eng.submit_decompress(s_blob[i]) for i in (1, 0, 1)]
    res, wall_ms, busy_ms = _busy_share(lambda: eng.run(clock="wall"))
    _check(not res[rbad].ok and isinstance(res[rbad].error,
                                           coder.StreamExhaustedError),
           f"a container cut short did not retire with StreamExhaustedError"
           f" ({res[rbad].error!r})")
    for i, r in zip((1, 0, 1), rd):
        _check(res[r].ok and np.array_equal(res[r].tokens, short[i])
               and np.array_equal(res[r].lane_probes, s_probes[i]),
               f"short decompress {i} beside a truncated container differs "
               "from lm_decompress_chunked")
    print(f"engine: one decompress cycle ({ENGINE_SLOTS} x {LANES} lanes x "
          f"{SHORT_T} steps; a container cut 3 bytes short per cell retires "
          "alone with StreamExhaustedError, its neighbours exact) under "
          f"torch.profiler: {wall_ms:.3f} ms wall, {busy_ms:.3f} ms device "
          f"busy ({100 * busy_ms / wall_ms:.1f}% busy)", flush=True)
    eng = engine("coder")
    rd = [eng.submit_decompress(b) for b in s_blob]
    rc = [eng.submit_compress(t) for t in short]
    res = eng.run()
    for i in (0, 1):
        _check(res[rd[i]].ok and np.array_equal(res[rd[i]].tokens, short[i])
               and np.array_equal(res[rd[i]].lane_probes, s_probes[i]),
               f"coder step backend: decompress {i} differs")
        _check(res[rc[i]].ok and res[rc[i]].blob == s_blob[i],
               f"coder step backend: compress {i} differs")
    print(f"engine: the coder step backend gives the kernel path's blobs, "
          f"tokens and per-lane probes on {SHORT_T}-symbol requests; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, dict(compress_symbols_per_s=syms / t_comp,
                          decompress_symbols_per_s=syms / t_dec,
                          busy_share=busy_ms / wall_ms), blobs


def _fig4c_train(cfg, rows, dev, steps: int = FIG4C_STEPS):
    """``bench_ratio._train_arch`` on the port: a seeded model of ``cfg``
    trained ``steps`` steps on the image rows as next-byte prediction.
    Returns the model and every step's loss (nats)."""
    import torch
    from repro_torch.models import init_model
    from repro_torch.train import train_loop

    model = init_model(cfg, seed=0, device=dev)
    state = train_loop.init_train_state(model)
    step = train_loop.make_train_step(cfg, base_lr=FIG4C_LR)
    b, s = FIG4C_BATCH, FIG4C_SEQ
    flat = rows.reshape(-1)
    n = (len(flat) - 1) // (b * s) * (b * s)
    losses = []
    for i in range(steps):
        off = (i * b * s) % max(n - b * s, 1)
        batch = {"tokens": flat[off:off + b * s].reshape(b, s),
                 "labels": flat[off + 1:off + 1 + b * s].reshape(b, s)}
        state, m = step(state, batch)
        losses.append(m["loss"])
    return model, torch.stack(losses).cpu().numpy()


def _neural_rung(model, rows, chunk: int, raw_bytes: int, what: str):
    """A trained model's rung: ``lm_compress_chunked`` on the kernel
    backend (B6 batch + B1) into the v2 container and the fused kernel
    decode (B2 + B6 per position) with the launches counted (exactly B1 1,
    B2 T, B6 T + 1) and no plain SPC on the card, bit-exact, and the coder
    backend's container byte-identical.  Returns the rung's record."""
    import numpy as np
    import torch
    from repro_torch.core import bitstream
    from repro_torch.kernels import LAUNCHES
    from repro_torch.serve import compress

    lanes, t_len = rows.shape
    before = dict(LAUNCHES)
    with _plain_spc_spy() as on_card:
        t0 = time.perf_counter()
        st = compress.lm_compress_chunked(model, rows, chunk,
                                          backend="kernel")
        blob = bitstream.pack_chunked(*st.chunks, chunk_size=chunk,
                                      n_symbols=t_len)
        sym, _ = compress.lm_decompress_chunked(
            model, bitstream.parse_chunked(blob), t_len, chunk,
            backend="kernel")
        torch.cuda.synchronize()
        t_code = time.perf_counter() - t0
    launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    _check(launches == _only(rans_encode_lanes=1, rans_decode_step=t_len,
                             spc_quantize=t_len + 1),
           f"{what}: launch counts {launches}")
    _check(not on_card, f"{what}: the plain SPC ran on the card "
           f"{len(on_card)} times on the kernel backend")
    _check(np.array_equal(sym.cpu().numpy(), rows),
           f"{what}: fused kernel decode not bit-exact")
    st_c = compress.lm_compress_chunked(model, rows, chunk, backend="coder")
    _check(bitstream.pack_chunked(*st_c.chunks, chunk_size=chunk,
                                  n_symbols=t_len) == blob,
           f"{what}: kernel and coder v2 containers differ")
    return dict(cr=raw_bytes / len(blob), blob_bytes=len(blob),
                bits_per_symbol=float(st.bits_per_symbol),
                model_xent_bits=float(st.model_xent_bits), code_s=t_code)


def _fig4c_neural(cfg, rows, dev, t_code: int):
    """One neural rung of the ladder: train on all of ``rows``, then
    :func:`_neural_rung` on each lane's first ``t_code`` symbols (one raw
    byte each) at the ladder's chunk.  Returns the rung's record with the
    model."""
    import numpy as np

    t0 = time.perf_counter()
    model, losses = _fig4c_train(cfg, rows, dev)
    t_train = time.perf_counter() - t0
    head, tail = float(losses[:10].mean()), float(losses[-10:].mean())
    _check(np.isfinite(losses).all() and tail < head,
           f"{cfg.name}: training loss did not fall ({head} -> {tail})")
    code_rows = np.ascontiguousarray(rows[:, :t_code])
    return dict(_neural_rung(model, code_rows, FIG4C_CHUNK, code_rows.size,
                             cfg.name), t_code=t_code,
                loss_first=float(losses[0]), loss_final=float(losses[-1]),
                train_s=t_train, model=model)


def _fig4c_latent(img, dev, raw_bytes: int):
    """``bench_ratio._latent_rung`` on the port: the Bit-Swap VAE trained
    on seeded images' 8 x 8 patches, then ``bb_encode`` of the image's
    512 patches on both pop backends (byte-identical stacks) and
    ``bb_decode`` through B2 (pixels and the initial stack back, no
    underflow).  Returns the rung's record."""
    import numpy as np
    import torch
    from repro_torch.core import stack
    from repro_torch.data.pipeline import synthetic_image
    from repro_torch.kernels import LAUNCHES, spc_quantize
    from repro_torch.models import vae

    h, w = img.shape
    cfg = vae.VAEConfig()

    def patch(im):
        return im.reshape(h // 8, 8, w // 8, 8).swapaxes(1, 2).reshape(
            -1, cfg.d_x)

    t0 = time.perf_counter()
    params, loss = vae.train_vae(
        cfg, lambda i: patch(synthetic_image(h, w, seed=100 + i)).astype(
            np.int64), steps=FIG4C_VAE_STEPS, lr=FIG4C_VAE_LR, seed=0,
        device=dev)
    t_train = time.perf_counter() - t0
    _check(np.isfinite(loss), f"VAE loss {loss}")
    x = torch.as_tensor(patch(img).astype(np.int64), device=dev)
    lanes = x.shape[0]
    st0 = stack.stack_init_bits(lanes, FIG4C_VAE_CAP, n_bytes=32, seed=7,
                                device=dev)
    before = dict(LAUNCHES)
    with _plain_spc_spy() as on_card, _b6_capture() as b6_calls:
        t0 = time.perf_counter()
        st = vae.bb_encode(st0, params, x, cfg, backend="kernel")
        b2_enc = LAUNCHES["rans_decode_step"] - before["rans_decode_step"]
        st_c = vae.bb_encode(st0, params, x, cfg, backend="coder")
        b2_mid = LAUNCHES["rans_decode_step"]
        st_d, x_d = vae.bb_decode(st, params, cfg, backend="kernel")
        b2_dec = LAUNCHES["rans_decode_step"] - b2_mid
        torch.cuda.synchronize()
        t_code = time.perf_counter() - t0
    launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    _check(not on_card, f"VAE: the plain SPC ran on the card {len(on_card)}"
           " times")
    _check(b2_enc == 2 * cfg.d_z and b2_dec == 2 * cfg.d_z + cfg.d_x,
           f"VAE: B2 launches {b2_enc} (encode) and {b2_dec} (decode) are "
           f"not the pops ({2 * cfg.d_z}, {2 * cfg.d_z + cfg.d_x})")
    # the tables' SPC: 4 B6 launches per bb_encode and per bb_decode
    _check(launches == _only(rans_decode_step=b2_enc + b2_dec,
                             spc_quantize=12), f"VAE launch counts {launches}")
    # B6 against its plain version at the phase's own table shapes: the
    # byte-identical stacks below hold only the pops, since both backends
    # quantize their tables through B6
    b6_err, b6_rows = 0, {}
    for probs, f, c in b6_calls:
        b6_err = max(b6_err, _max_abs_err(
            (f, c), spc_quantize.spc_freq_cdf_plain(probs.cpu(),
                                                    cfg.prob_bits)))
        b6_rows[probs.shape[-1]] = b6_rows.get(probs.shape[-1], set()) | {
            probs.shape[0]}
    want_rows = {cfg.z_bins: {cfg.d_z * lanes}, cfg.x_bins: {cfg.d_x * lanes}}
    _check(len(b6_calls) == 12 and b6_rows == want_rows,
           f"VAE: B6 calls {len(b6_calls)} at rows {b6_rows}, expected 12 "
           f"at {want_rows}")
    print(f"fig4c VAE: B6 == plain on all 12 table sets (rows per K "
          f"{ {k: sorted(v) for k, v in b6_rows.items()} }, max abs err "
          f"{b6_err})", flush=True)
    _check(not bool(st.underflow.any()), "VAE encode underflowed")
    _check(all(bool(torch.equal(a, b)) for a, b in zip(st, st_c)),
           "VAE: kernel and coder stacks differ")
    _check(bool(torch.equal(x_d, x)), "VAE: bb_decode pixels not bit-exact")
    live = all(bool(torch.equal(st_d.buf[i, p:], st0.buf[i, p:]))
               for i, p in enumerate(st0.ptr.tolist()))
    _check(bool(torch.equal(st_d.s, st0.s)) and bool(torch.equal(
        st_d.ptr, st0.ptr)) and live, "VAE: initial stack not restored")
    _check(not bool(st_d.underflow.any()), "VAE decode underflowed")
    net = int((stack.stack_bytes(st) - stack.stack_bytes(st0)).sum())
    return dict(cr=raw_bytes / net, net_bytes=net, lanes=lanes,
                elbo_bits_per_pixel=loss / math.log(2) / cfg.d_x,
                b2_pops=b2_enc + b2_dec, train_s=t_train,
                code_s=t_code)


def fig4c_phase(dev):
    """The Fig. 4(c) ratio ladder (``benchmarks/bench_ratio.run``) on the
    card: zlib, the static histogram, ``ras-pimc`` trained at full width
    and at the smoke width, and the bits-back VAE; every ratio beside the
    reference's ``BENCH_ratio.json`` figure (CPU-interpret JAX), with the
    phase's B1/B2/B6 launches counted from 0."""
    import zlib
    import numpy as np
    import torch
    from repro_torch.configs.ras_pimc import CONFIG, SMOKE
    from repro_torch.core import bitstream
    from repro_torch.data.pipeline import synthetic_image
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve import compress

    ref = json.loads((ROOT / "BENCH_ratio.json").read_text())
    img = synthetic_image(FIG4C_H, FIG4C_W, seed=0)
    raw = img.tobytes()
    rows = img.reshape(FIG4C_LANES, -1).astype(np.int64)
    reset_launches()
    ladder = {"zlib(PNG-DEFLATE)": len(raw) / len(zlib.compress(raw, 9))}
    enc, _ = compress.histogram_compress(rows, 256, device=dev)
    ladder["rANS-static-histogram"] = len(raw) / bitstream.compressed_size(
        enc.length)
    rungs = {}
    t_len = rows.shape[1]
    for name, cfg, t_code in (("full", CONFIG, FIG4C_FULL_T),
                              ("smoke", SMOKE, t_len)):
        rungs[name] = _fig4c_neural(cfg, rows, dev, t_code)
    ladder["rANS-neural(ras-pimc)"] = rungs["smoke"]["cr"]
    rungs["vae"] = _fig4c_latent(img, dev, len(raw))
    ladder["rANS-bitsback-latent(vae)"] = rungs["vae"]["cr"]
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    _check(launches == _only(rans_encode_lanes=2,
                             rans_decode_step=t_len + FIG4C_FULL_T
                             + rungs["vae"]["b2_pops"],
                             spc_quantize=t_len + FIG4C_FULL_T + 2 + 12),
           f"Fig. 4(c) launch counts {launches}")
    print(f"fig4c: {FIG4C_H}x{FIG4C_W} synthetic_image(seed=0) as "
          f"{FIG4C_LANES} lanes x {t_len}, chunk {FIG4C_CHUNK}; CR here "
          "(reference BENCH_ratio.json, CPU-interpret JAX):", flush=True)
    for name, cr in ladder.items():
        print(f"fig4c:   {name}: {cr:.4f} ({ref[name]:.4f})", flush=True)
    for name, cfg in (("full", CONFIG), ("smoke", SMOKE)):
        r = rungs[name]
        final_bits = r["loss_final"] / math.log(2)
        print(f"fig4c: {cfg.name} ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}), each lane's first {r['t_code']} symbols: CR "
              f"{r['cr']:.4f}, {r['bits_per_symbol']:.4f} "
              f"bits/symbol against the model's {r['model_xent_bits']:.4f}-bit"
              f" cross entropy over the stream; train loss "
              f"{r['loss_first']:.4f} -> {r['loss_final']:.4f} nats "
              f"({final_bits:.4f} bits; reference smoke "
              f"{ref['_pimc_train_loss_bits']:.4f} bits) in {FIG4C_STEPS} "
              f"steps, {r['train_s']:.1f} s; compress + fused decode "
              f"{r['code_s']:.1f} s; kernel and coder containers "
              "byte-identical, decode bit-exact", flush=True)
    v = rungs["vae"]
    print(f"fig4c: VAE ({v['lanes']} patches of 8x8): net {v['net_bytes']} "
          f"stack bytes, CR {v['cr']:.4f}; ELBO {v['elbo_bits_per_pixel']:.4f}"
          f" bits/pixel (reference {ref['_vae_elbo_bits_per_pixel']:.4f}); "
          f"train {v['train_s']:.1f} s, bb_encode x2 + bb_decode "
          f"{v['code_s']:.1f} s; kernel and coder stacks byte-identical, "
          f"decode bit-exact with the initial stack restored, B2 launches = "
          f"{v['b2_pops']} pops", flush=True)
    print(f"fig4c: launches {launches}; no plain SPC call on the card on "
          "the kernel paths", flush=True)
    return launches, rungs["smoke"]


# --- the recurrent families (slice 6) -------------------------------------

# mamba2-130m at full width: 16 lanes x 256 token_stream(50280) tokens,
# chunk 128, prob_bits 16 (its vocabulary needs the SPC's ceiling), top-4;
# the engine: 2 slots x 16 lanes at max_len 128 (the requests are longer).
# 256 tokens keep the whole script well inside its time limit beside the
# mixtral phase.
M2_LANES, M2_T, M2_CHUNK, M2_BITS = 16, 256, 128, 16
# its depth: 4 of 24 layers (6 before the recurrent placement checks
# came, 12 before the MoE placement checks came, the whole model before
# the tooling phases came; cut for the script's time limit, the width and
# the coded K stay)
M2_LAYERS = 4
M2_SLOTS, M2_MAX_LEN = 2, 128
M2_CPU_ROWS, M2_CPU_STEPS = 2, 4
# B6 beyond the register layouts, against the plain SPC: K and rows
WIDE_K = ((16385, 4), (65536, 4))
# recurrentgemma-2b SMOKE: 8 lanes x 64 (its 16-slot ring wraps 4 times)
HYB_LANES, HYB_T, HYB_CHUNK = 8, 64, 16


@contextlib.contextmanager
def _last_call(module, name: str):
    """Keep the arguments of the last call of ``module.name`` in the block
    (the call itself runs unchanged); yields a dict with ``args`` and
    ``kwargs``."""
    fn, seen = getattr(module, name), {}

    def keep(*a, **kw):
        seen["args"], seen["kwargs"] = a, kw
        return fn(*a, **kw)

    setattr(module, name, keep)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


def _zoo_slice(model, tokens, chunk: int, bits: int, what: str):
    """A zoo model's slice through the kernel backend with counters reset
    just before and read just after, then the coder backend (``what``
    names it in the checks); returns the run's numbers and the B6/B2
    inputs it last saw."""
    import numpy as np
    import torch
    from repro_torch.core import bitstream
    from repro_torch.kernels import LAUNCHES, ops, reset_launches
    from repro_torch.kernels import spc_quantize
    from repro_torch.serve import compress

    t_len = tokens.shape[1]
    torch.cuda.reset_peak_memory_stats()
    with _plain_spc_spy() as on_card, \
            _last_call(ops, "spc_quantize_tables") as b6_batch, \
            _last_call(spc_quantize, "spc_freq_cdf") as b6_pos, \
            _last_call(ops, "rans_decode_step") as b2_pop:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = compress.lm_compress_chunked(model, tokens, chunk,
                                          prob_bits=bits,
                                          backend="kernel")
        torch.cuda.synchronize()
        t_comp = time.perf_counter() - t0
        blob = bitstream.pack_chunked(*st.chunks, chunk_size=chunk,
                                      n_symbols=t_len, prob_bits=bits)
        cs = bitstream.parse_chunked(blob)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sym, avg, lane_probes = compress.lm_decompress_chunked(
            model, cs, t_len, chunk, prob_bits=bits, backend="kernel",
            lane_probes=True)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    _check(launches == _only(rans_encode_lanes=1, rans_decode_step=t_len,
                             spc_quantize=t_len + 1),
           f"{what} launch counts {launches}")
    _check(not on_card, f"the plain SPC ran on the card {len(on_card)} times"
           f" on the {what} kernel path")
    _branch("rans_decode_step", _step_branches(b2_pop["args"][3]),
            f"{what} B2, last position")
    _check(np.array_equal(sym.cpu().numpy(), tokens),
           f"{what} round trip not exact")
    st_c = compress.lm_compress_chunked(model, tokens, chunk,
                                        prob_bits=bits, backend="coder")
    _check(bitstream.pack_chunked(*st_c.chunks, chunk_size=chunk,
                                  n_symbols=t_len, prob_bits=bits) == blob,
           f"{what}: coder and kernel containers differ")
    del st_c
    sym_c, _, lane_probes_c = compress.lm_decompress_chunked(
        model, cs, t_len, chunk, prob_bits=bits, backend="coder",
        lane_probes=True)
    _check(np.array_equal(sym_c.cpu().numpy(), tokens),
           f"{what}: coder round trip not exact")
    _check(torch.equal(lane_probes_c, lane_probes),
           f"{what}: per-lane probes differ between backends")
    return dict(launches=launches, blob=blob, lane_probes=lane_probes,
                bits=float(st.bits_per_symbol),
                xent=float(st.model_xent_bits), avg_probes=float(avg),
                t_comp=t_comp, t_dec=t_dec, peak=peak,
                b6_batch=b6_batch["args"], b6_pos=b6_pos["args"],
                b2_pop=(b2_pop["args"], b2_pop["kwargs"]))


def _zoo_kernels(run, bits: int, what: str, wide=()):
    """B6 at a zoo slice's two shapes (and at each K of ``wide``), and B2
    at its per-lane rows (and on a shared, zero-frequency and mismatched
    row), each against its plain version on the card, timed beside its
    bound; returns the two kernels' large-K records."""
    import numpy as np
    import torch
    from repro_torch.core import spc
    from repro_torch.kernels import rans_decode, spc_quantize

    out = {}
    probs16 = run["b6_pos"][0]                   # (16, K) BF16, with CDF
    batch = run["b6_batch"][0]                   # (8192, K) BF16
    for name, probs, with_cdf in (("position", probs16, True),
                                  ("batch", batch, False)):
        fn = spc_quantize.spc_freq_cdf if with_cdf else \
            spc_quantize.spc_quantize
        plain = (lambda p: spc.freq_cdf_from_probs(p, bits)) \
            if with_cdf else (lambda p: spc.quantize_probs(p, bits))
        got, want = fn(probs, bits), plain(probs)
        if not with_cdf:
            got, want = (got,), (want,)
        err = _max_abs_err(got, want)
        b, k = probs.shape
        ms = _device_ms(lambda: fn(probs, bits), n=20 if b <= 256 else 3)
        plain_ms = _median_ms(lambda: plain(probs), repeats=3, warmup=1)
        bound_ms, bound_by, moved = _spc_bound(b, k, probs.element_size(),
                                               with_cdf)
        print(f"{what}: B6 at {b} x {k} BF16{' with the CDF' * with_cdf}: "
              f"kernel == plain; {ms:.4f} ms kernel on the device, "
              f"{plain_ms:.4f} ms plain, bound {bound_ms:.6f} ms by "
              f"{bound_by} ({moved} B moved)", flush=True)
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, err=err)
    rng = np.random.default_rng(5)
    for k, b in wide:
        p = torch.as_tensor(rng.dirichlet(np.full(k, 0.5), size=b),
                            dtype=torch.float32, device=probs16.device)
        for x in (p, spc.store_bf16(p)):
            err = _max_abs_err(spc_quantize.spc_freq_cdf(x, 16),
                               spc.freq_cdf_from_probs(x, 16))
            out["batch"]["err"] = max(out["batch"]["err"], err)
    if wide:
        print(f"{what}: B6 kernel == plain at K = "
              f"{', '.join(str(k) for k, _ in wide)} (float32 and BF16, "
              "with the CDF)", flush=True)
    (buf, s, ptr, freq, cdf), kw = run["b2_pop"][0][:5], run["b2_pop"][1]
    args = (buf, s, ptr, freq, cdf)
    err = _max_abs_err(rans_decode.rans_decode_step(*args, **kw),
                       rans_decode.rans_decode_step_plain(*args, **kw))
    want = _step_branches(freq)
    _branch("rans_decode_step", want, f"B2 at K = {freq.shape[-1]}")
    # the same pop on a shared row, on rows with zero frequencies (every
    # third lane's symbols 3..6 moved to symbol 128) and on a freq that is
    # not the cdf's differences, with and without the candidates
    zf = freq.clone()
    zf[::3, 128] += zf[::3, 3:7].sum(-1)
    zf[::3, 3:7] = 0
    zt = spc.build_tables(zf, bits)
    bent = (freq + torch.randint(0, 3, freq.shape, device=freq.device,
                                 dtype=freq.dtype,
                                 generator=torch.Generator(
                                     device=freq.device).manual_seed(2)))
    for f_rows, c_rows in ((freq[0], cdf[0]), (zt.freq, zt.cdf),
                           (bent, cdf)):
        for kc in (kw, dict(kw, candidates=None)):
            cargs = (buf, s, ptr, f_rows.contiguous(), c_rows.contiguous())
            err = max(err, _max_abs_err(
                rans_decode.rans_decode_step(*cargs, **kc),
                rans_decode.rans_decode_step_plain(*cargs, **kc)))
            _branch("rans_decode_step", want,
                    f"B2 at K = {freq.shape[-1]} on a shared, zero-frequency"
                    " or mismatched row")
    ms = _device_ms(lambda: rans_decode.rans_decode_step(*args, **kw), n=50)
    plain_ms = _median_ms(lambda: rans_decode.rans_decode_step_plain(
        *args, **kw), repeats=5)
    one = rans_decode.rans_decode_step_plain(*args, **kw)
    bound_ms, bound_by, moved, ops = _b2_bound(one, ptr, TOPK)
    print(f"{what}: B2 at {buf.shape[0]} lanes x K = {freq.shape[-1]} "
          f"(per-lane rows, top-{TOPK}; also a shared row, zero-frequency "
          f"rows and a mismatched (freq, cdf) pair, each with and without "
          f"the candidates; paths {sorted(want)}): kernel == plain; "
          f"{ms:.4f} ms kernel"
          f" on the device, {plain_ms:.3f} ms plain, bound {bound_ms:.8f} ms"
          f" by {bound_by} ({moved} B moved, {ops} ops)", flush=True)
    out["b2"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, err=err)
    return out


def _zoo_card_vs_cpu(cpu, card, rows: int, steps: int, what: str,
                     memory=None):
    """The same weights on the CPU and on the card, ``rows`` x ``steps``
    decode steps of seeded tokens (against ``memory``, a CPU tensor, for a
    model with cross attention): the largest logit difference, at most
    1e-4."""
    import torch
    from repro_torch.models import decode_step, init_state

    toks = torch.randint(0, cpu.cfg.vocab_size, (rows, steps),
                         generator=torch.Generator().manual_seed(0))
    models = (cpu, card)
    states = [init_state(m, rows, steps) for m in models]
    mems = [None if memory is None else memory.to(m.embedding.device)
            for m in models]
    worst = 0.0
    for t in range(steps):
        lg = [decode_step(m, st, toks[:, t:t + 1].to(m.embedding.device), t,
                          memory=mem)
              for m, st, mem in zip(models, states, mems)]
        _check(bool(torch.isfinite(lg[1]).all()), "non-finite logits")
        worst = max(worst, float((lg[1].cpu() - lg[0]).abs().max()))
    _check(worst <= 1e-4, f"{what}: card logits differ from the CPU's by "
           f"{worst}")
    print(f"{what}, {rows} rows x {steps} steps, card vs CPU: max abs "
          f"logit diff {worst:.3e} (tolerance 1e-4)", flush=True)
    return worst


def _zoo_engine(model, tokens, run, *, chunk: int, bits: int, slots: int,
                max_len: int, what: str, prefill: bool):
    """``slots`` slots x the slice's lanes at ``max_len``: two compress
    requests, ``tokens`` and a second stream of one chunk (which retires
    while the first runs on; both of the slice's length before the
    tooling phases came, cut for the script's time limit), then their
    decompress; blobs byte-identical to ``lm_compress_chunked``'s,
    tokens exact, probes equal.  With ``prefill`` the compress cycles must
    run as prefill chunks and every cycle's device half runs under
    ``torch.cuda.set_sync_debug_mode("error")``; without, no cycle may
    prefill."""
    import numpy as np
    import torch
    from repro_torch.core import bitstream
    from repro_torch.data.pipeline import token_stream
    from repro_torch.serve import compress
    from repro_torch.serve.engine import BatchEngine

    lanes, t_len = tokens.shape
    other = token_stream(model.cfg.vocab_size, (lanes, chunk), seed=1)
    st = compress.lm_compress_chunked(model, other, chunk,
                                      prob_bits=bits, backend="kernel")
    blob_other = bitstream.pack_chunked(*st.chunks, chunk_size=chunk,
                                        n_symbols=chunk, prob_bits=bits)
    del st
    eng = BatchEngine(model, slots=slots, lanes=lanes, chunk_size=chunk,
                      max_len=max_len, prob_bits=bits, step_backend="kernel",
                      prefill="auto")
    eng.check_sync = prefill
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit_compress(x) for x in (tokens, other)]
    with _plain_spc_spy() as on_card:
        res = eng.run()
        torch.cuda.synchronize()
        t_comp = time.perf_counter() - t0
    for rid, want in zip(rids, (run["blob"], blob_other)):
        _check(res[rid].ok and res[rid].blob == want,
               f"{what} engine request {rid}: blob differs from the "
               "single-request path")
    t0 = time.perf_counter()
    dids = [eng.submit_decompress(res[r].blob) for r in rids]
    with _plain_spc_spy() as on_card_dec:
        out = eng.run()
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
    _check(not on_card and not on_card_dec,
           f"the plain SPC ran on the card in the {what} engine")
    for did, want in zip(dids, (tokens, other)):
        _check(out[did].ok and np.array_equal(out[did].tokens, want),
               f"{what} engine decompress {did} not exact")
    _check(np.array_equal(out[dids[0]].lane_probes,
                          run["lane_probes"].cpu().numpy()),
           f"{what} engine probes differ from the single-request decode")
    _check((eng.prefill_cycles > 0) == prefill,
           f"{what} engine ran {eng.prefill_cycles} prefill cycles")
    n = lanes * (t_len + chunk)
    print(f"{what} engine: {slots} slots x {lanes} lanes, max_len "
          f"{max_len}, requests of {t_len} and {chunk} tokens: blobs "
          f"byte-identical "
          f"to lm_compress_chunked, decodes exact, probes equal; "
          f"{eng.prefill_cycles} prefill cycles"
          f"{' (no host sync in a cycle)' * prefill}; compress "
          f"{n / t_comp:.1f} symbols/s ({t_comp:.3f} s), decompress "
          f"{n / t_dec:.1f} symbols/s ({t_dec:.3f} s)", flush=True)


def _smoke_blob(model, x, chunk: int, backend: str) -> bytes:
    """``x``'s v2 container at the default ``prob_bits``."""
    from repro_torch.core import bitstream
    from repro_torch.serve import compress

    st = compress.lm_compress_chunked(model, x, chunk, backend=backend)
    return bitstream.pack_chunked(*st.chunks, chunk_size=chunk,
                                  n_symbols=x.shape[1])


def _smoke_roundtrip(model, toks, chunk: int, what: str):
    """A SMOKE model through the kernel backend with its launches counted
    (B1 once, B2 and B6 once a position), the coder's container
    byte-identical and the fused decode exact; returns the container, the
    per-lane probes and the launches."""
    import numpy as np
    import torch
    from repro_torch.core import bitstream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve import compress

    t_len = toks.shape[1]
    with _plain_spc_spy() as on_card:
        reset_launches()
        blob = _smoke_blob(model, toks, chunk, "kernel")
        sym, _, lp = compress.lm_decompress_chunked(
            model, bitstream.parse_chunked(blob), t_len, chunk,
            backend="kernel", lane_probes=True)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
    _check(launches == _only(rans_encode_lanes=1, rans_decode_step=t_len,
                             spc_quantize=t_len + 1),
           f"{what} launch counts {launches}")
    _check(not on_card, f"the plain SPC ran on the card on the {what} path")
    _check(blob == _smoke_blob(model, toks, chunk, "coder"),
           f"{what}: coder and kernel containers differ")
    _check(np.array_equal(sym.cpu().numpy(), toks),
           f"{what} round trip not exact")
    return blob, lp, launches


def _hybrid(dev):
    """recurrentgemma-2b SMOKE on the card: kernel and coder containers
    byte-identical, the fused decode exact (its launches counted), and an
    engine run in which one slot's last chunk is short (the frozen rows)
    with ``prefill="auto"`` stepping down."""
    import numpy as np
    from repro_torch.configs.recurrentgemma_2b import SMOKE
    from repro_torch.data.pipeline import token_stream
    from repro_torch.models import init_model
    from repro_torch.serve.engine import BatchEngine

    model = init_model(SMOKE, seed=0, device=dev)
    toks = token_stream(SMOKE.vocab_size, (HYB_LANES, HYB_T), seed=2)
    blob, lp, launches = _smoke_roundtrip(model, toks, HYB_CHUNK, "hybrid")
    short = token_stream(SMOKE.vocab_size, (HYB_LANES, 40), seed=3)
    eng = BatchEngine(model, slots=2, lanes=HYB_LANES, chunk_size=HYB_CHUNK,
                      max_len=2 * SMOKE.local_window, prefill="auto",
                      step_backend="kernel")
    _check(not eng._prefill, "hybrid engine kept a prefill path")
    rids = [eng.submit_compress(x) for x in (short, toks)]
    with _plain_spc_spy() as on_card:
        res = eng.run()
    _check(not on_card, "the plain SPC ran on the card in the hybrid engine")
    wants = (_smoke_blob(model, short, HYB_CHUNK, "kernel"), blob)
    for rid, want in zip(rids, wants):
        _check(res[rid].ok and res[rid].blob == want,
               f"hybrid engine request {rid}: blob differs")
    dids = [eng.submit_decompress(res[r].blob) for r in rids]
    with _plain_spc_spy() as on_card:
        out = eng.run()
    _check(not on_card, "the plain SPC ran on the card in the hybrid engine")
    for did, x in zip(dids, (short, toks)):
        _check(out[did].ok and np.array_equal(out[did].tokens, x),
               f"hybrid engine decompress {did} not exact")
    _check(np.array_equal(out[dids[1]].lane_probes, lp.cpu().numpy()),
           "hybrid engine probes differ from the single-request decode")
    _check(eng.prefill_cycles == 0, "hybrid engine ran a prefill cycle")
    print(f"hybrid: {SMOKE.name} ({SMOKE.n_layers} layers, stages "
          f"{SMOKE.stages}, local window {SMOKE.local_window}), "
          f"{HYB_LANES} lanes x {HYB_T}, chunk {HYB_CHUNK}: kernel and coder"
          f" containers byte-identical, fused decode exact, launches "
          f"{launches}; engine (2 slots, a 40-token request whose last "
          f"chunk is short beside a {HYB_T}-token one): blobs byte-identical, "
          "decodes exact, prefill='auto' stepped down", flush=True)


def mamba2_phase(dev):
    """The recurrent families on the card: ``mamba2-130m`` at full width
    (BF16, vocab 50,280, ``prob_bits=16``; ``M2_LAYERS`` of its 24 layers)
    through the kernel and coder
    backends, its kernels at K = 50,280, the card against the CPU, the
    engine on streams longer than ``max_len``, the same model placed for
    compute (:func:`_placed_serve`), and the hybrid's smoke round trip
    and engine.  Returns the slice's launches, the large-K kernel records
    and the placed compress's launches."""
    import torch
    from repro_torch.configs.mamba2_130m import CONFIG as FULL
    from repro_torch.data.pipeline import token_stream
    from repro_torch.models import decode_step, init_model, init_state

    cfg = FULL.with_(n_layers=M2_LAYERS)
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device=dev)
    tokens = token_stream(cfg.vocab_size, (M2_LANES, M2_T), seed=0)
    run = _zoo_slice(model, tokens, M2_CHUNK, M2_BITS, "mamba2")
    n = M2_LANES * M2_T
    print(f"mamba2: {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype}), "
          f"{M2_LANES} lanes x {M2_T} tokens, chunk {M2_CHUNK}, prob_bits "
          f"{M2_BITS}: round trip bit-exact, kernel and coder containers "
          f"byte-identical, per-lane probes equal; launches "
          f"{run['launches']}; no plain SPC call on the card", flush=True)
    state = init_state(model, M2_LANES, M2_T)
    tok = torch.zeros((M2_LANES, 1), dtype=torch.int64, device=dev)
    step_ms = _median_ms(lambda: decode_step(model, state, tok, 0),
                         repeats=20)
    print(f"mamba2: bits/symbol {run['bits']:.4f}, model xent "
          f"{run['xent']:.4f} bits, avg probes/symbol "
          f"{run['avg_probes']:.4f}, container {len(run['blob'])} bytes; "
          f"compress {n / run['t_comp']:.1f} symbols/s "
          f"({run['t_comp']:.3f} s), decompress {n / run['t_dec']:.1f} "
          f"symbols/s ({run['t_dec']:.3f} s); model step {step_ms:.3f} ms "
          f"({M2_LANES} rows); peak memory "
          f"{run['peak'] / 2**30:.2f} GiB", flush=True)
    recs = _alone(functools.partial(_zoo_kernels, dict(run), M2_BITS,
                                    "mamba2", wide=WIDE_K))
    _zoo_card_vs_cpu(*(init_model(cfg.with_(dtype="float32"), seed=1,
                                  device=d) for d in ("cpu", dev)),
                     M2_CPU_ROWS, M2_CPU_STEPS,
                     "mamba2: full width in float32")
    _zoo_engine(model, tokens, run, chunk=M2_CHUNK, bits=M2_BITS,
                slots=M2_SLOTS, max_len=M2_MAX_LEN, what="mamba2",
                prefill=False)
    del run["b6_batch"], run["b6_pos"], run["b2_pop"]
    torch.cuda.empty_cache()
    placed = _placed_serve(dev, model, None, M2_BITS,
                           f"mamba2 placed: {cfg.name} ({cfg.n_layers} "
                           "layers, BF16)")
    del model
    torch.cuda.empty_cache()
    _hybrid(dev)
    print(f"mamba2 slice: {time.perf_counter() - t0:.1f} s", flush=True)
    return run["launches"], recs, placed


# --- the MoE family (slice 7) ----------------------------------------------

# mixtral-8x22b at full width, its depth cut to 2 of 56 layers (5.01 GB of
# BF16 weights a layer): 16 lanes x 512 token_stream(32768) tokens, chunk
# 128, prob_bits 16, top-4; the engine: 2 slots x 16 lanes at max_len 512
# (the requests fit the ring, so prefill="auto" prefills their cycles);
# MX_STEPS steps timed alone and traced for the device-busy share
MX_LAYERS = 2        # of 56 (4 before the tooling phases came)
MX_LANES, MX_T, MX_CHUNK, MX_BITS = 16, 512, 128, 16
MX_SLOTS, MX_MAX_LEN, MX_STEPS = 2, 512, 8
MX_CPU_ROWS, MX_CPU_STEPS = 2, 4
# mixtral-8x22b SMOKE: 8 lanes x 64 (its 16-slot window wraps 4 times)
MXS_LANES, MXS_T, MXS_CHUNK = 8, 64, 16


def _step_bytes(model, rows: int) -> int:
    """The weights a decode step of ``rows`` rows must read: every
    parameter but the embedding table (of which it gathers ``rows`` rows)
    and the encoder's (the memory is encoded before the steps)."""
    emb = model.embedding
    enc = 0 if model.encoder is None else sum(
        p.numel() * p.element_size() for p in model.encoder.parameters())
    return (sum(p.numel() * p.element_size() for p in model.parameters())
            - emb.numel() * emb.element_size() - enc
            + rows * emb.shape[1] * emb.element_size())


def _mx_step(dev, model, rows: int, max_len: int, what: str):
    """One ``rows``-row decode step of the cut model: its median time, and
    ``MX_STEPS`` steps under ``torch.profiler`` for the device-busy share,
    beside the bytes a step must read (:func:`_step_bytes`)."""
    import torch
    from repro_torch.models import decode_step, init_state

    state = init_state(model, rows, max_len)
    tok = torch.zeros((rows, 1), dtype=torch.int64, device=dev)
    step_ms = _median_ms(lambda: decode_step(model, state, tok, 0),
                         repeats=20)
    _, wall_ms, busy_ms = _busy_share(lambda: [
        decode_step(model, state, tok, t) for t in range(MX_STEPS)])
    from repro_torch.analysis.roofline import HBM_BYTES_PER_S
    moved = _step_bytes(model, rows)
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    print(f"{what}: model step {step_ms:.3f} ms ({rows} rows), bound "
          f"{bound_ms:.3f} ms by bytes ({moved} B of weights a step); "
          f"{MX_STEPS} steps traced: {wall_ms:.3f} ms wall, {busy_ms:.3f} "
          f"ms device busy ({100 * busy_ms / wall_ms:.1f}% busy)", flush=True)


def _mx_smoke(dev):
    """mixtral-8x22b SMOKE on the card, its 16-slot window wrapping 4
    times: kernel and coder containers byte-identical, the fused decode
    exact, its launches counted."""
    from repro_torch.configs.mixtral_8x22b import SMOKE
    from repro_torch.data.pipeline import token_stream
    from repro_torch.models import init_model, init_state

    model = init_model(SMOKE, seed=0, device=dev)
    _check(init_state(model, MXS_LANES, MXS_T).length == SMOKE.window,
           "mixtral SMOKE ring is not its window")
    toks = token_stream(SMOKE.vocab_size, (MXS_LANES, MXS_T), seed=2)
    _, _, launches = _smoke_roundtrip(model, toks, MXS_CHUNK,
                                      "mixtral SMOKE")
    print(f"mixtral SMOKE: {SMOKE.n_layers} layers, {SMOKE.n_experts} "
          f"experts top-{SMOKE.topk_experts}, window {SMOKE.window}, "
          f"{MXS_LANES} lanes x {MXS_T} (the ring wraps "
          f"{MXS_T // SMOKE.window - 1} times), chunk {MXS_CHUNK}: kernel "
          f"and coder containers byte-identical, fused decode exact, "
          f"launches {launches}", flush=True)


# the MoE family's compute placement (slice 16) on the world-1 NCCL mesh
# 1 x 1: the mixtral and phi slices' models decode MOE_DEC_ROWS rows for
# MOE_DEC_T positions and compress MOE_PLACED (lanes, tokens, chunk)
# placed; phi's float32 layer trains MOE_TRAIN_ROWS x MOE_TRAIN_SEQ
MOE_DEC_ROWS, MOE_DEC_T = 16, 32
MOE_PLACED = (16, 128, 64)
MOE_TRAIN_ROWS, MOE_TRAIN_SEQ = 2, 512


def _placed_serve(dev, model, rule, bits: int, what: str) -> dict:
    """``model`` (a full-width slice's) placed on a world-1 NCCL mesh 1 x
    1, a MoE model under the MoE ``rule`` (``"experts"`` or ``"mlp"``;
    None without experts): its decode of ``MOE_DEC_ROWS`` rows bitwise
    the plain model's (logits and every state leaf), its placed compress
    and decompress (``MOE_PLACED``,
    ``prob_bits=bits``, ``backend="kernel"``) byte-identical to the whole
    model's container with exact tokens and equal probes, launches B1 1 /
    B2 T / B6 T + 1
    counted from 0, and the dry-run of its decode cell on the 1 x 1 mesh
    at the card's parameter and state bytes.  Returns the launches."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import ShapeSpec
    from repro_torch.data.pipeline import token_stream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_for, mesh_shape_for
    from repro_torch.parallel import sharding
    from repro_torch.serve import compress
    cfg = model.cfg
    lanes, t_len, chunk = MOE_PLACED
    smi = _smi()
    _nccl_world1(dev)
    try:
        dm = make_mesh_for(1, device=dev)
        placed = sharding.place_model(model, dm)
        pl = placed.placement
        _check(pl.moe_rule == rule, f"{what}: MoE rule {pl.moe_rule}, "
               f"expected {rule}")
        rng = np.random.default_rng(29)
        tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (
            MOE_DEC_ROWS, MOE_DEC_T)), device=dev)
        out, ms = {}, {}
        for name, m in (("plain", model), ("placed", placed)):
            st = m.init_state(MOE_DEC_ROWS, t_len)
            lgs = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(MOE_DEC_T):
                lgs.append(m.decode_step(st, tok[:, t:t + 1], t))
            torch.cuda.synchronize()
            ms[name] = 1e3 * (time.perf_counter() - t0) / MOE_DEC_T
            out[name] = (lgs, st)
        (lp, sp), (lw, sw) = out["placed"], out["plain"]
        _check(all(torch.equal(pl.whole_vocab(a), b) for a, b in zip(lp, lw))
               and all(torch.equal(t, sw.leaves()[k])
                       for k, t in sp.leaves().items()),
               f"{what}: the placed decode is not bitwise the plain "
               "model's")
        param_bytes = _nbytes(placed.parameters())
        state_bytes = _nbytes(sp.leaves().values())
        del out, lp, sp, lw, sw
        tokens = token_stream(cfg.vocab_size, (lanes, t_len), seed=29)
        want = compress.lm_compress_chunked(model, tokens, chunk, bits,
                                            backend="kernel")
        _, _, want_probes = compress.lm_decompress_chunked(
            model, want.chunks, t_len, chunk, bits, backend="kernel",
            lane_probes=True)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = compress.lm_compress_chunked(placed, tokens, chunk, bits,
                                           backend="kernel")
        torch.cuda.synchronize()
        t_comp = time.perf_counter() - t0
        t0 = time.perf_counter()
        sym, _, probes = compress.lm_decompress_chunked(
            placed, got.chunks, t_len, chunk, bits, backend="kernel",
            lane_probes=True)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        del placed
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    _check(launches == _only(rans_encode_lanes=1, rans_decode_step=t_len,
                             spc_quantize=t_len + 1),
           f"{what}: launch counts {launches}")
    _check(all(torch.equal(a, b) for a, b in zip(got.chunks, want.chunks)),
           f"{what}: the placed container differs from the whole model's")
    _check(np.array_equal(sym.cpu().numpy(), tokens),
           f"{what}: round trip not exact")
    _check(torch.equal(probes, want_probes),
           f"{what}: per-lane probes differ from the whole model's")
    rec = dryrun.run_cell(cfg.name, ShapeSpec(
        f"decode {MOE_DEC_ROWS}x{t_len}", t_len, MOE_DEC_ROWS, "decode"),
        mesh=mesh_shape_for(1), overrides={"n_layers": cfg.n_layers},
        verbose=False)
    _check(rec["status"] == "OK", f"{what}: dry-run {rec.get('error')}")
    mem = rec["memory"]
    got_b = (mem["param_bytes"], mem["activation_bytes"])
    _check(got_b == (param_bytes, state_bytes), f"{what}: dry-run "
           f"parameter and state bytes {got_b}, the card's "
           f"{(param_bytes, state_bytes)}")
    n = lanes * t_len
    how = f" (MoE rule {rule!r})" if rule else ""
    print(f"{what}: placed on the 1x1 mesh{how}; "
          f"{MOE_DEC_ROWS} rows x {MOE_DEC_T} positions decoded, each "
          f"step's logits and the state bitwise the plain model's (a step "
          f"{ms['placed']:.3f} ms placed, {ms['plain']:.3f} ms plain, host "
          f"wall); {lanes} lanes x {t_len} tokens, chunk {chunk}, "
          f"prob_bits {bits}: the "
          f"placed container byte-identical to the whole model's, round "
          f"trip exact, per-lane probes equal, compress {n / t_comp:.1f} / "
          f"decompress {n / t_dec:.1f} symbols/s, launches {launches}; "
          f"dry-run of the placed decode cell (compute): parameter and "
          f"state bytes {got_b} equal to the card's ({smi})", flush=True)
    return launches


def _placed_train(dev, model, what: str, rows: int = MOE_TRAIN_ROWS,
                  seq: int = MOE_TRAIN_SEQ, rule="experts",
                  overrides: dict | None = None) -> dict:
    """``model`` (full-width float32 layers) trained plain, in place, and
    placed on a world-1 NCCL mesh 1 x 1 from the same weights
    (``_tp_run``: ``grads_fn``'s loss and gradients, the prefill logits,
    two steps of ``rows`` x ``seq`` ``train_batch`` tokens), each leaf
    within 1e-5 of its largest entry, a MoE model under the MoE ``rule``
    (None without experts); step times and peaks; the dry-run of the
    placed train cell on the 1 x 1 mesh at the card's parameter, gradient
    and moment bytes (the cut's ``overrides`` of its registry config
    beside its depth, dtype and ``remat``).  Returns the step times and
    the largest differences."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import ShapeSpec
    from repro_torch.data.pipeline import train_batch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_for, mesh_shape_for
    from repro_torch.parallel import sharding
    smi = _smi()
    cfg = model.cfg = model.cfg.with_(grad_accum=1)
    batch = train_batch(cfg, rows, seq, step=0)
    steps = [train_batch(cfg, rows, seq, step=i) for i in (1, 2)]
    _nccl_world1(dev)
    try:
        dm = make_mesh_for(1, device=dev)
        placed = sharding.place_model(model, dm)
        _check(placed.placement.moe_rule == rule,
               f"{what}: MoE rule {placed.placement.moe_rule}")
        ref = _tp_run(model, batch, steps)
        torch.cuda.empty_cache()
        o = _tp_run(placed, batch, steps, device_mesh=dm)
        worst = {
            "loss": _tp_worst({"l": o["loss"]}, {"l": ref["loss"]},
                              f"{what}: loss"),
            "grads": _tp_worst(o["grads"], ref["grads"],
                               f"{what}: gradients"),
            "logits": _tp_worst({"l": o["logits"]}, {"l": ref["logits"]},
                                f"{what}: prefill logits"),
            "params": _tp_worst(o["params"], ref["params"],
                                f"{what}: parameters after 2 steps")}
        del placed, ref["grads"], o["grads"], o["params"]
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    over = dict(n_layers=cfg.n_layers, dtype=cfg.dtype, grad_accum=1,
                remat=cfg.remat, **(overrides or {}))
    rec = dryrun.run_cell(cfg.name, ShapeSpec(f"{rows}x{seq}", seq, rows,
                                              "train"),
                          mesh=mesh_shape_for(1), overrides=over,
                          verbose=False)
    _check(rec["status"] == "OK", f"{what}: dry-run {rec.get('error')}")
    mem = rec["memory"]
    got = (mem["param_bytes"], mem["grad_bytes"], mem["optimizer_bytes"])
    want = (o["param_bytes"], o["grad_bytes"], o["moment_bytes"])
    _check(got == want, f"{what}: dry-run parameter, gradient and moment "
           f"bytes {got}, the card's {want}")
    how = f" (MoE rule {rule!r})" if rule else ""
    print(f"{what}: placed on the 1x1 mesh{how}: loss, "
          f"gradients, prefill logits and parameters after 2 steps within "
          f"{worst['loss']:.3e} / {worst['grads']:.3e} / "
          f"{worst['logits']:.3e} / {worst['params']:.3e} of each leaf's "
          f"largest entry of the plain model's (limit 1e-5); step "
          f"{ref['ms']:.1f} ms plain, {o['ms']:.1f} ms placed; the step's "
          f"own peak {ref['own'] / 2**30:.2f} GiB plain, "
          f"{o['own'] / 2**30:.2f} GiB placed ({o['own']} B); loss "
          f"{float(ref['loss']):.6f}; dry-run of the placed train cell on "
          f"the 1x1 mesh (compute) {mem['total_bytes'] / 2**30:.2f} GiB "
          f"({mem['total_bytes']} B; parameter, gradient and moment bytes "
          f"equal to the card's) ({smi})", flush=True)
    return dict(ms=o["ms"], plain_ms=ref["ms"], worst=worst)


def moe_phase(dev):
    """The MoE family on the card: ``mixtral-8x22b`` at full width, cut to
    ``MX_LAYERS`` layers (BF16, vocab 32,768, ``prob_bits=16``), through
    the kernel and coder backends; its step's time and device-busy share;
    B6 and B2 at K = 32,768; one full-width layer against the CPU; the
    engine with prefill cycles; and the SMOKE model's wrapping window.
    Returns the slice's launches and the large-K kernel records."""
    import torch
    from repro_torch.configs.mixtral_8x22b import CONFIG
    from repro_torch.data.pipeline import token_stream
    from repro_torch.models import LM, init_model

    t0 = time.perf_counter()
    cfg = CONFIG.with_(n_layers=MX_LAYERS)
    model = init_model(cfg, seed=0, device=dev, draw="device")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    tokens = token_stream(cfg.vocab_size, (MX_LANES, MX_T), seed=0)
    run = _zoo_slice(model, tokens, MX_CHUNK, MX_BITS, "mixtral")
    n = MX_LANES * MX_T
    print(f"mixtral: {cfg.name} at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads x {cfg.head_dim_}, kv {cfg.n_kv_heads}, d_ff "
          f"{cfg.d_ff}, {cfg.n_experts} experts top-{cfg.topk_experts}, "
          f"window {cfg.window}, vocab {cfg.vocab_size}, {cfg.dtype}, untied"
          f" head), depth cut to {cfg.n_layers} of {CONFIG.n_layers} layers "
          f"({n_params} parameters, drawn on the card in {t_init:.1f} s), "
          f"{MX_LANES} lanes x {MX_T} tokens, chunk {MX_CHUNK}, prob_bits "
          f"{MX_BITS}: round trip bit-exact, kernel and coder containers "
          f"byte-identical, per-lane probes equal; launches "
          f"{run['launches']}; no plain SPC call on the card", flush=True)
    print(f"mixtral: bits/symbol {run['bits']:.4f}, model xent "
          f"{run['xent']:.4f} bits, avg probes/symbol "
          f"{run['avg_probes']:.4f}, container {len(run['blob'])} bytes; "
          f"compress {n / run['t_comp']:.1f} symbols/s "
          f"({run['t_comp']:.3f} s), decompress {n / run['t_dec']:.1f} "
          f"symbols/s ({run['t_dec']:.3f} s); peak memory "
          f"{run['peak'] / 2**30:.2f} GiB", flush=True)
    _mx_step(dev, model, MX_LANES, MX_T, "mixtral")
    recs = _alone(functools.partial(_zoo_kernels, dict(run), MX_BITS,
                                    "mixtral"))
    # one float32 layer drawn on the card, its weights copied to the CPU
    one = CONFIG.with_(n_layers=1, dtype="float32")
    card = init_model(one, seed=1, device=dev, draw="device")
    cpu = LM(one)
    cpu.load_state_dict(card.state_dict())
    _zoo_card_vs_cpu(cpu, card, MX_CPU_ROWS, MX_CPU_STEPS,
                     "mixtral: one full-width layer in float32")
    del cpu, card
    torch.cuda.empty_cache()
    _zoo_engine(model, tokens, run, chunk=MX_CHUNK, bits=MX_BITS,
                slots=MX_SLOTS, max_len=MX_MAX_LEN, what="mixtral",
                prefill=True)
    del run["b6_batch"], run["b6_pos"], run["b2_pop"]
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    placed = _placed_serve(dev, model, "mlp", MX_BITS,
                               f"mixtral placed: {cfg.n_layers} of "
                               f"{CONFIG.n_layers} layers ({cfg.dtype})")
    print(f"mixtral placed: {time.perf_counter() - t1:.1f} s", flush=True)
    del model
    torch.cuda.empty_cache()
    _mx_smoke(dev)
    print(f"mixtral slice: {time.perf_counter() - t0:.1f} s", flush=True)
    return run["launches"], recs, placed


# --- training of the recurrent families and the dense zoo (slice 8) --------

# bench_ratio._zoo_frontier: the Fig. 4(c) image's first 256 symbols of each
# of its 16 lanes, chunk 128; mamba2-130m and recurrentgemma-2b SMOKE trained
# 60 steps (8 x 128 at lr 3e-3, _train_arch); ras-pimc is the Fig. 4(c)
# phase's smoke model (120 steps over the whole image, as the reference's)
ZOO_T, ZOO_CHUNK, ZOO_STEPS = 256, 128, 60
# mamba2-130m at full width as a trainer: ZOO_M2_STEPS BF16 steps of 4 x 512
# token_stream tokens from the end of the lr warmup (4 before the remat
# phase came), then its first step in float32 on the card and on the CPU
# at 2 x 256 (the CPU side stays short)
ZOO_M2_STEPS, ZOO_M2_BATCH, ZOO_M2_SEQ, ZOO_M2_WARM = 3, 4, 512, 100
ZOO_M2_CPU_BATCH, ZOO_M2_CPU_SEQ = 2, 256
# the dense zoo: one full-width float32 layer, card vs CPU (decode steps and
# a 256-token forward); blockwise attention at S 2,048, attn_block 1,024
DZ_ROWS, DZ_STEPS, DZ_FWD_T = 2, 4, 256
DZ_BLOCK_T, DZ_BLOCK = 2048, 1024
# the dense SMOKE round trips: 8 lanes x 64, chunk 16
DZS_LANES, DZS_T, DZS_CHUNK = 8, 64, 16
# the decode's top-k at the mixtral slice's rows
TOPK_ROWS, TOPK_K = 16, 32768
# activation checkpointing: qwen3-4b's train_4k config cut to 8 of 36
# layers, one row of the cell's 4,096 tokens; each trainer's extra steps
# without its recompute
REMAT_ARCH, REMAT_LAYERS, REMAT_ROWS = "qwen3-4b", 8, 1
REMAT_PLAIN_STEPS = 2


def zoo_phase(dev, pimc):
    """The Fig. 4(c) zoo rungs (``bench_ratio._zoo_frontier``) on the card:
    ``mamba2-130m`` and ``recurrentgemma-2b`` SMOKE trained on the image's
    rows, ``ras-pimc`` SMOKE from the Fig. 4(c) phase (``pimc``, its rung
    record), each through :func:`_neural_rung` at 16 lanes x 256, chunk
    128; every CR, bits/symbol and model entropy (the last step's loss in
    bits) beside ``BENCH_ratio.json``'s.  Returns the phase's launches,
    counted from 0."""
    import numpy as np
    from repro_torch.configs import SERVE_SMOKE_ARCHS, get_smoke_config
    from repro_torch.data.pipeline import synthetic_image
    from repro_torch.kernels import LAUNCHES, reset_launches

    ref = {p["arch"]: p for p in json.loads(
        (ROOT / "BENCH_ratio.json").read_text())["_zoo_frontier"]}
    img = synthetic_image(FIG4C_H, FIG4C_W, seed=0)
    rows = img.reshape(FIG4C_LANES, -1)[:, :ZOO_T].astype(np.int64)
    reset_launches()
    for arch in SERVE_SMOKE_ARCHS:
        if arch == "ras-pimc":
            model, loss, t_train, steps = (pimc["model"], pimc["loss_final"],
                                           pimc["train_s"], FIG4C_STEPS)
        else:
            t0 = time.perf_counter()
            model, losses = _fig4c_train(get_smoke_config(arch), rows, dev,
                                         steps=ZOO_STEPS)
            t_train, steps = time.perf_counter() - t0, ZOO_STEPS
            head, tail = float(losses[:10].mean()), float(losses[-10:].mean())
            _check(np.isfinite(losses).all() and tail < head,
                   f"{arch}: training loss did not fall ({head} -> {tail})")
            loss = float(losses[-1])
        r = _neural_rung(model, rows, ZOO_CHUNK, rows.size, f"zoo {arch}")
        want = ref[arch]
        print(f"zoo: {arch} SMOKE ({model.cfg.family}), trained {steps} "
              f"steps in {t_train:.1f} s: CR {r['cr']:.4f} (reference "
              f"{want['cr']:.4f}), {r['bits_per_symbol']:.4f} bits/symbol "
              f"({want['bits_per_symbol']:.4f}), model entropy "
              f"{loss / math.log(2):.4f} bits "
              f"({want['model_entropy_bits']:.4f}); stream cross entropy "
              f"{r['model_xent_bits']:.4f} bits; compress + fused decode "
              f"{r['code_s']:.1f} s; kernel and coder containers "
              "byte-identical, decode bit-exact", flush=True)
    launches = dict(LAUNCHES)
    n = len(SERVE_SMOKE_ARCHS)
    _check(launches == _only(rans_encode_lanes=n,
                             rans_decode_step=n * ZOO_T,
                             spc_quantize=n * (ZOO_T + 1)),
           f"zoo launch counts {launches}")
    print(f"zoo: {FIG4C_LANES} lanes x {ZOO_T}, chunk {ZOO_CHUNK}; launches "
          f"{launches}; no plain SPC call on the card", flush=True)
    return launches


def _without_remat(state, cfg, batch, base_lr: float, what: str,
                   remat_ms: float, remat_peak: int):
    """``REMAT_PLAIN_STEPS`` more train steps of a trainer's ``state`` on
    ``batch`` with ``remat=False`` (its model's config swapped for them and
    put back), the last one timed, printed beside the trainer's step with
    its recompute (``remat_ms``, ``remat_peak``).  Returns the new state;
    ``state`` is spent (its moments are freed)."""
    import torch
    from repro_torch.train import train_loop

    model = state.model
    remat_cfg = model.cfg
    _check(remat_cfg.remat, f"{what}: its config does not checkpoint")
    step = train_loop.make_train_step(cfg.with_(remat=False),
                                      base_lr=base_lr)
    model.cfg = remat_cfg.with_(remat=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        for _ in range(REMAT_PLAIN_STEPS):
            t0 = time.perf_counter()
            new, m = step(state, batch)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            # the caller's state holds the moments the step replaced: free
            # them, as a trainer's loop does when it rebinds its state
            state.opt.m.clear()
            state.opt.v.clear()
            state = new
    finally:
        model.cfg = remat_cfg
    loss = float(m["loss"])
    peak = torch.cuda.max_memory_allocated()
    _check(math.isfinite(loss), f"{what} without remat: loss {loss}")
    print(f"{what}: step with its recompute (remat=True) {remat_ms:.1f} ms, "
          f"peak {remat_peak / 2**30:.2f} GiB; without (remat=False, "
          f"{REMAT_PLAIN_STEPS} steps, the last timed) {1e3 * secs:.1f} ms, "
          f"peak {peak / 2**30:.2f} GiB", flush=True)
    return state


def mamba2_train_phase(dev):
    """``mamba2-130m`` at full width as a trainer: ``ZOO_M2_STEPS`` BF16
    train steps on the card (losses, step time, peak memory), then its
    first step in float32 on the card and on the CPU from the same
    weights and batch: loss and gradient norm within 1e-4 relative.
    Returns the BF16 train state (for :func:`bf16_checkpoint_phase`) and
    the trainer's cell record (:func:`_train_record`)."""
    import numpy as np
    import torch
    from repro_torch.configs.mamba2_130m import CONFIG
    from repro_torch.data.pipeline import train_batch
    from repro_torch.models import LM, init_model
    from repro_torch.train import train_loop

    model = init_model(CONFIG, seed=0, device=dev, draw="device")
    state = train_loop.init_train_state(model)
    state = state._replace(step=torch.full_like(state.step, ZOO_M2_WARM))
    step = train_loop.make_train_step(CONFIG, base_lr=FIG4C_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    with _grad_bytes() as grads:
        for i in range(ZOO_M2_STEPS):
            batch = train_batch(CONFIG, ZOO_M2_BATCH, ZOO_M2_SEQ, step=i)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    record = _train_record("mamba2-130m", "mamba2 trainer", ZOO_M2_BATCH,
                           ZOO_M2_SEQ, {"grad_accum": CONFIG.grad_accum},
                           state, grads, peak)
    _check(np.isfinite(losses).all(), f"mamba2 trainer losses {losses}")
    print(f"mamba2 trainer: {CONFIG.name} at full width ({CONFIG.n_layers} "
          f"layers, d_model {CONFIG.d_model}, vocab {CONFIG.vocab_size}, "
          f"{CONFIG.dtype}), {ZOO_M2_STEPS} steps of {ZOO_M2_BATCH} x "
          f"{ZOO_M2_SEQ} tokens from step {ZOO_M2_WARM}: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)} nats; step "
          f"{1e3 * statistics.median(secs[1:]):.1f} ms (median of steps "
          f"2-{ZOO_M2_STEPS}; the first {1e3 * secs[0]:.1f} ms); peak memory"
          f" {peak / 2**30:.2f} GiB", flush=True)
    state = _without_remat(state, CONFIG, batch, FIG4C_LR, "mamba2 trainer",
                           1e3 * statistics.median(secs[1:]), peak)
    del model, step
    torch.cuda.empty_cache()
    cfg = CONFIG.with_(dtype="float32")
    card = init_model(cfg, seed=1, device=dev, draw="device")
    cpu = LM(cfg)
    cpu.load_state_dict(card.state_dict())
    batch = train_batch(cfg, ZOO_M2_CPU_BATCH, ZOO_M2_CPU_SEQ, step=0)
    got = []
    for m in (cpu, card):
        _, met = train_loop.make_train_step(cfg, base_lr=FIG4C_LR)(
            train_loop.init_train_state(m), batch)
        got.append((float(met["loss"]), float(met["grad_norm"])))
    rel = max(abs(a - b) / abs(b) for a, b in zip(got[1], got[0]))
    _check(np.isfinite(got[1]).all() and rel <= 1e-4,
           f"mamba2 trainer: card (loss, grad norm) {got[1]} against the "
           f"CPU's {got[0]}")
    print(f"mamba2 trainer: first step in float32 at {ZOO_M2_CPU_BATCH} x "
          f"{ZOO_M2_CPU_SEQ}, card vs CPU: loss {got[1][0]:.6f} / "
          f"{got[0][0]:.6f}, grad norm {got[1][1]:.6f} / {got[0][1]:.6f}, "
          f"max relative difference {rel:.3e} (tolerance 1e-4)", flush=True)
    return state, record


def _dz_perturb(model, seed: int) -> None:
    """Move the attention biases and q/k norm scales off their inits (zeros
    and ones) and draw the padded query heads' weights (zero at init) by
    seeded draws on the model's device, so a check reads them."""
    import torch

    cfg = model.cfg
    g = torch.Generator(device=model.embedding.device).manual_seed(seed)
    with torch.no_grad():
        for blk in model.blocks:
            for name, p in blk.attn.named_parameters():
                if name in ("bq", "bk", "bv", "q_norm", "k_norm"):
                    p.add_(0.1 * torch.randn(p.shape, generator=g,
                                             device=p.device))
            for p in (blk.attn.wq[:, cfg.n_heads:], blk.attn.wo[cfg.n_heads:]):
                p.copy_(0.02 * torch.randn(p.shape, generator=g,
                                           device=p.device))


def dense_zoo_phase(dev):
    """The dense zoo on the card: ``qwen3-4b`` (QK norm, 32 heads x 128
    over d_model 2,560) and ``qwen1.5-4b`` (QKV bias, 20 heads padded to 32
    over 20 kv heads) at full width cut to one float32 layer, their
    vocabularies kept, card against CPU (decode steps through
    :func:`_zoo_card_vs_cpu` and a 256-token ``forward``, logits within
    1e-4); ``llama3-405b``'s blockwise attention at ``qwen3-4b``'s head
    shapes against the naive schedule on the card; and the four SMOKE
    models' round trips through the kernel backend."""
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import token_stream
    from repro_torch.models import LM, init_model
    from repro_torch.models.attention import attn_forward

    for arch in ("qwen3-4b", "qwen1.5-4b"):
        cfg = get_config(arch).with_(n_layers=1, dtype="float32")
        card = init_model(cfg, seed=1, device=dev, draw="device")
        _dz_perturb(card, 2)
        cpu = LM(cfg)
        cpu.load_state_dict(card.state_dict())
        what = (f"{arch}: one full-width layer in float32 ({cfg.n_heads} "
                f"heads padded to {cfg.n_heads_padded} x {cfg.head_dim_} over"
                f" {cfg.n_kv_heads} kv heads, d_model {cfg.d_model}, vocab "
                f"{cfg.vocab_size})")
        _zoo_card_vs_cpu(cpu, card, DZ_ROWS, DZ_STEPS, what)
        toks = torch.randint(0, cfg.vocab_size, (1, DZ_FWD_T),
                             generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            lg = [m._logits(m(toks.to(m.embedding.device))[0])
                  for m in (cpu, card)]
        err = float((lg[1].cpu() - lg[0]).abs().max())
        _check(bool(torch.isfinite(lg[1]).all()) and err <= 1e-4,
               f"{arch}: forward logits differ from the CPU's by {err}")
        print(f"{arch}: {DZ_FWD_T}-token forward, card vs CPU: max abs "
              f"logit diff {err:.3e} (tolerance 1e-4)", flush=True)
        if arch == "qwen3-4b":
            gen = torch.Generator(device=dev).manual_seed(3)
            x = torch.randn((1, DZ_BLOCK_T, cfg.d_model), device=dev,
                            generator=gen)
            blk = cfg.with_(attn_impl="blockwise", attn_block=DZ_BLOCK)
            a = card.blocks[0].attn
            with torch.no_grad():
                yb, yn = (attn_forward(a, x, c) for c in (blk, cfg))
                ms_b = _median_ms(lambda: attn_forward(a, x, blk), repeats=5)
                ms_n = _median_ms(lambda: attn_forward(a, x, cfg), repeats=5)
            err = float((yb - yn).abs().max())
            _check(bool(torch.isfinite(yb).all()) and err <= 1e-4,
                   f"blockwise attention differs from naive by {err}")
            print(f"blockwise attention (llama3-405b's schedule) at {arch}'s "
                  f"heads, S {DZ_BLOCK_T}, attn_block {DZ_BLOCK}, float32: "
                  f"max abs diff against naive {err:.3e} (tolerance 1e-4); "
                  f"{ms_b:.3f} ms blockwise, {ms_n:.3f} ms naive", flush=True)
        del cpu, card, lg
        torch.cuda.empty_cache()
    for arch in ("qwen1.5-4b", "qwen3-4b", "qwen3-32b", "llama3-405b"):
        cfg = get_smoke_config(arch)
        model = init_model(cfg, seed=0, device=dev)
        toks = token_stream(cfg.vocab_size, (DZS_LANES, DZS_T), seed=2)
        _, _, launches = _smoke_roundtrip(model, toks, DZS_CHUNK,
                                          f"{arch} SMOKE")
        print(f"{arch} SMOKE: {DZS_LANES} lanes x {DZS_T}, chunk "
              f"{DZS_CHUNK}: kernel and coder containers byte-identical, "
              f"fused decode exact, launches {launches}", flush=True)


def _leaf_diffs(grads: dict, ref: dict) -> dict:
    """Each gradient leaf's largest |difference| from ``ref`` (on the
    host), in float32."""
    return {k: float((g.float() - ref[k].to(g.device).float()).abs().max())
            for k, g in grads.items()}


def remat_phase(dev):
    """Activation checkpointing at full width: ``qwen3-4b``'s ``train_4k``
    config (BF16, naive attention, after ``tune_for_shape``) cut to
    ``REMAT_LAYERS`` of 36 layers, ``grad_accum`` 1, one batch of
    ``REMAT_ROWS`` x 4,096 ``train_batch`` tokens.  From the same seeded
    weights, ``remat=False``, ``remat=True`` and ``remat=False`` again
    (the card's own repeat), each run ``grads_fn`` (the forward and
    backward's peak), then one train step, timed, with its peak: the
    losses bitwise equal; each gradient leaf of the checkpointed run
    bitwise equal to the first run's, or no farther from it than the
    repeat's; the checkpointed step's peak below both plain steps'; each
    beside the dry-run's reckoned total on the 1 x 1 mesh, whose
    parameter, gradient and moment bytes equal the card's."""
    import torch
    from repro_torch.configs import SHAPES, ShapeSpec, get_config
    from repro_torch.data.pipeline import train_batch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import mesh_shape_for
    from repro_torch.launch.specs import tune_for_shape
    from repro_torch.models import init_model
    from repro_torch.train import train_loop

    smi = _smi()
    shape = SHAPES["train_4k"]
    over = {"n_layers": REMAT_LAYERS, "grad_accum": 1}
    base = tune_for_shape(get_config(REMAT_ARCH), shape).with_(**over)
    _check(base.dtype == "bfloat16" and base.attn_impl == "naive",
           f"{REMAT_ARCH} train_4k config {base.dtype}, {base.attn_impl}")
    batch = train_batch(base, REMAT_ROWS, shape.seq_len, step=0)
    what = (f"remat: {REMAT_ARCH} train_4k at full width, {REMAT_LAYERS} of "
            f"36 layers ({base.dtype}, {base.attn_impl} attention), "
            f"{REMAT_ROWS} x {shape.seq_len} tokens")
    ref = None      # the first run's loss and gradients, on the host
    out = []
    for remat in (False, True, False):
        cfg = base.with_(remat=remat)
        model = init_model(cfg, seed=0, device=dev, draw="device")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, grads = train_loop.grads_fn(model, batch)
        torch.cuda.synchronize()
        o = dict(remat=remat, loss=loss.cpu(), param=_nbytes(
            model.parameters()), grad=_nbytes(grads.values()),
            bwd_peak=torch.cuda.max_memory_allocated())
        if ref is None:
            ref = (o["loss"], {k: g.cpu() for k, g in grads.items()})
            o["diffs"] = dict.fromkeys(grads, 0.0)
        else:
            o["diffs"] = _leaf_diffs(grads, ref[1])
        del loss, grads
        state = train_loop.init_train_state(model)
        step = train_loop.make_train_step(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        o["ms"] = 1e3 * (time.perf_counter() - t0)
        o["peak"] = torch.cuda.max_memory_allocated()
        o["moments"] = _nbytes(list(state.opt.m.values())
                               + list(state.opt.v.values()))
        o["step_loss"] = m["loss"].cpu()
        out.append(o)
        del model, state, step, m
        torch.cuda.empty_cache()
    for o in out:
        _check(torch.equal(o["loss"], ref[0])
               and torch.equal(o["step_loss"], ref[0])
               and bool(torch.isfinite(o["loss"])), f"{what}: losses "
               f"{[(float(x['loss']), float(x['step_loss'])) for x in out]}"
               " differ")
    ck, rep = out[1]["diffs"], out[2]["diffs"]
    bad = [k for k in ck if ck[k] and ck[k] > rep[k]]
    _check(not bad, f"{what}: the checkpointed gradients {bad[:4]} differ "
           f"from the plain run's beyond the card's repeat: "
           f"{[(ck[k], rep[k]) for k in bad[:4]]}")
    _check(out[1]["peak"] < min(out[0]["peak"], out[2]["peak"]),
           f"{what}: peak with remat {out[1]['peak']} B, without "
           f"{out[0]['peak']} / {out[2]['peak']} B")
    print(f"{what}: loss {float(ref[0]):.6f} nats bitwise equal in all 3 "
          f"runs; gradients: {sum(v == 0 for v in ck.values())} of "
          f"{len(ck)} leaves bitwise equal with remat, max |dg| "
          f"{max(ck.values()):.3e}; the plain repeat "
          f"{sum(v == 0 for v in rep.values())} of {len(rep)}, max |dg| "
          f"{max(rep.values()):.3e}; forward + backward peak "
          f"{out[0]['bwd_peak'] / 2**30:.2f} / "
          f"{out[1]['bwd_peak'] / 2**30:.2f} / "
          f"{out[2]['bwd_peak'] / 2**30:.2f} GiB (plain / remat / plain)",
          flush=True)

    cell = ShapeSpec(f"{REMAT_ROWS}x{shape.seq_len}", shape.seq_len,
                     REMAT_ROWS, "train")
    recs = {r: dryrun.run_cell(REMAT_ARCH, cell, mesh=mesh_shape_for(1),
                               overrides={**over, "remat": r}, verbose=False)
            for r in (False, True)}
    for o in out:
        rec = recs[o["remat"]]
        _check(rec["status"] == "OK", f"{what}: dry-run {rec.get('error')}")
        mem = rec["memory"]
        got = (mem["param_bytes"], mem["grad_bytes"], mem["optimizer_bytes"])
        want = (o["param"], o["grad"], o["moments"])
        _check(got == want, f"{what}: dry-run parameter, gradient and "
               f"moment bytes {got}, the card's {want}")
        print(f"{what}, remat={o['remat']}: step {o['ms']:.1f} ms; peak "
              f"{o['peak'] / 2**30:.2f} GiB ({o['peak']} B); dry-run on "
              f"the 1x1 mesh {mem['total_bytes'] / 2**30:.2f} GiB "
              f"({mem['total_bytes']} B: activations "
              f"{mem['activation_bytes']} B, of them "
              f"{mem['recompute_bytes']} B a unit's recompute; parameter, "
              f"gradient and moment bytes equal to the card's), ratio "
              f"{mem['total_bytes'] / o['peak']:.3f} ({smi})", flush=True)


TP_ARCH, TP_LAYERS, TP_ROWS, TP_SEQ, TP_LR = "qwen3-4b", 2, 2, 1024, 3e-3
TP_SP = (("data",), "model", None)
# the placed decode: positions stepped into a ring of TP_SEQ, of them the
# prefilled chunk; the placed ras-pimc compress (lanes x tokens, chunk)
TP_DEC_T, TP_DEC_PREFILL = 64, 32
TP_PIMC = (128, 128, 64)


def _tp_run(model, batch: dict, steps: list, device_mesh=None) -> dict:
    """One model's loss and gradients (``grads_fn``), its prefill logits
    and two train steps (``TP_LR``): the outputs on the card, the second
    step's time, the steps' peak memory above what was allocated before
    them plus the model's parameters (``own``: the step's peak without
    the other models the phase holds), and the bytes of its parameters,
    last gradients and moments (the rank's, when placed)."""
    import torch
    from repro_torch.train import train_loop
    pl = model.placement
    loss, grads = train_loop.grads_fn(model, batch)
    p = model.embedding
    tokens = torch.as_tensor(batch["tokens"], dtype=torch.int64,
                             device=p.device)
    mem = {k: torch.as_tensor(batch[k], device=p.device).to(p.dtype)
           for k in ("memory", "enc_inputs") if k in batch}
    with torch.no_grad():
        if pl is None:
            x, _ = model(tokens, **mem)
        else:
            x, _ = model(pl.rows(tokens),
                         **{k: pl.rows(v) for k, v in mem.items()})
        lg = model._logits(x)
    del x
    state = train_loop.init_train_state(model)
    step = train_loop.make_train_step(model.cfg, base_lr=TP_LR,
                                      device_mesh=device_mesh)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with _grad_bytes() as seen:
        for b in steps:
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    _check(bool(torch.isfinite(m["loss"])), f"step loss {m['loss']}")
    param_bytes = _nbytes(model.parameters())
    return dict(loss=loss, grads=grads, logits=lg, ms=ms,
                own=torch.cuda.max_memory_allocated() - base + param_bytes,
                params={k: p.detach() for k, p in model.named_parameters()},
                param_bytes=param_bytes, grad_bytes=seen[-1],
                moment_bytes=_nbytes(list(state.opt.m.values())
                                     + list(state.opt.v.values())))


def _tp_worst(got: dict, ref: dict, what: str) -> float:
    """The largest |difference| over every leaf of ``got`` from ``ref``,
    each over the leaf's largest |entry|; fails above 1e-5."""
    import torch
    keys = list(ref)
    rel = torch.stack([(got[k].float() - ref[k].float()).abs().max()
                       / ref[k].float().abs().max().clamp(min=1e-30)
                       for k in keys])
    worst = float(rel.max())
    _check(worst <= 1e-5 and bool(torch.isfinite(rel).all()),
           f"{what}: {worst:.3e} of the leaf's largest entry, over 1e-5 "
           f"(leaf {keys[int(rel.argmax())]})")
    return worst


def _tp_decode(dev, whole, dm, what: str) -> dict:
    """The placed decode at full width (checks (a) and (b) of the tensor
    parallel phase): ``whole`` and its placement on ``dm`` decode
    ``TP_ROWS`` rows of seeded tokens for ``TP_DEC_T`` positions into a
    ring of ``TP_SEQ``, each step's logits within 1e-5 of the plain
    model's largest logit, the final state too; the placed
    ``prefill_chunk`` of the first ``TP_DEC_PREFILL`` positions into a
    fresh state bitwise the placed steps (logits and state).  The ring's
    layout is the reference's ``slots``, and the placement keeps its
    context-parallel step on this mesh's one model rank
    (``place_model(slots_at_one=True)``: the masked slab write, the
    slab's softmax partials and ``softmax_combine``), so the logits are
    the plain model's within rounding.  Returns the worst differences,
    the step times and the rank's tensors' bytes."""
    import numpy as np
    import torch
    from repro_torch.parallel import sharding
    cfg = whole.cfg
    placed = sharding.place_model(whole, dm, slots_at_one=True)
    pl = placed.placement
    layout = pl.serving(TP_SEQ).ring
    _check(layout == "slots", f"{what}: the step's ring layout {layout}, "
           "expected the slots (kv heads 8 do not divide over tp 16)")
    rng = np.random.default_rng(28)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                       (TP_ROWS, TP_DEC_T)), device=dev)
    out = {}
    for name, m in (("plain", whole), ("placed", placed)):
        state = m.init_state(TP_ROWS, TP_SEQ)
        lgs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(TP_DEC_T):
            lgs.append(m.decode_step(state, tok[:, t:t + 1], t))
            if name == "placed" and t + 1 == TP_DEC_PREFILL:
                snap = (state.k.clone(), state.v.clone())
        torch.cuda.synchronize()
        out[name] = dict(ms=1e3 * (time.perf_counter() - t0) / TP_DEC_T,
                         logits=lgs, state=state)
    worst = max(_tp_worst({"l": pl.whole_vocab(a)}, {"l": b},
                          f"{what}: decode step {t} logits")
                for t, (a, b) in enumerate(zip(out["placed"]["logits"],
                                               out["plain"]["logits"])))
    final = pl.unplace_state(out["placed"]["state"])
    state_worst = _tp_worst({"k": final.k, "v": final.v},
                            {"k": out["plain"]["state"].k,
                             "v": out["plain"]["state"].v},
                            f"{what}: decode state")
    fresh = placed.init_state(TP_ROWS, TP_SEQ)
    n = TP_DEC_PREFILL
    lg = placed.prefill_chunk(fresh, tok[:, :n],
                              torch.zeros(TP_ROWS, dtype=torch.int64,
                                          device=dev),
                              torch.full((TP_ROWS,), n, dtype=torch.int64,
                                         device=dev))
    _check(torch.equal(lg, torch.stack(out["placed"]["logits"][:n], 1))
           and torch.equal(fresh.k, snap[0]) and torch.equal(fresh.v,
                                                             snap[1]),
           f"{what}: the placed prefill_chunk of {n} positions is not "
           "bitwise the placed steps")
    st = out["placed"]["state"]
    return dict(worst=worst, state_worst=state_worst, layout=layout,
                ms=out["placed"]["ms"], plain_ms=out["plain"]["ms"],
                param_bytes=_nbytes(placed.parameters()),
                state_bytes=_nbytes([st.k, st.v]))


def _tp_compress(dev, dm, what: str) -> dict:
    """Check (c) of the tensor parallel phase: ``ras-pimc`` ``CONFIG``
    placed on ``dm`` through ``lm_compress_chunked`` and
    ``lm_decompress_chunked(backend="kernel")`` (``TP_PIMC``): the
    container byte-identical to the whole model's, the round trip exact,
    the per-lane probes the whole model's; the launches of the placed
    compress and decompress alone."""
    import numpy as np
    import torch
    from repro_torch.configs.ras_pimc import CONFIG
    from repro_torch.data.pipeline import token_stream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import init_model
    from repro_torch.parallel import sharding
    from repro_torch.serve import compress
    lanes, t_len, chunk = TP_PIMC
    model = init_model(CONFIG, seed=0, device=dev)
    placed = sharding.place_model(model, dm)
    _check(placed.placement.ring_layout(t_len) == "kv_heads",
           f"{what}: ring layout {placed.placement.ring_layout(t_len)}")
    tokens = token_stream(CONFIG.vocab_size, (lanes, t_len), seed=28)
    want = compress.lm_compress_chunked(model, tokens, chunk,
                                        backend="kernel")
    _, _, want_probes = compress.lm_decompress_chunked(
        model, want.chunks, t_len, chunk, backend="kernel", lane_probes=True)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = compress.lm_compress_chunked(placed, tokens, chunk,
                                       backend="kernel")
    torch.cuda.synchronize()
    t_comp = time.perf_counter() - t0
    t0 = time.perf_counter()
    sym, _, probes = compress.lm_decompress_chunked(
        placed, got.chunks, t_len, chunk, backend="kernel", lane_probes=True)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    _check(launches == _only(rans_encode_lanes=1, rans_decode_step=t_len,
                             spc_quantize=t_len + 1),
           f"{what}: launch counts {launches}")
    _check(all(torch.equal(a, b) for a, b in zip(got.chunks, want.chunks)),
           f"{what}: the placed container differs from the whole model's")
    _check(np.array_equal(sym.cpu().numpy(), tokens),
           f"{what}: round trip not exact")
    _check(torch.equal(probes, want_probes),
           f"{what}: per-lane probes differ from the whole model's")
    return dict(launches=launches, comp=lanes * t_len / t_comp,
                dec=lanes * t_len / t_dec)


def tensor_parallel_phase(dev):
    """Slice 14: the dense family's compute placement at full width on a
    world-1 NCCL group (``make_mesh_for(1)``, a (1, 1) ``DeviceMesh``):
    ``qwen3-4b`` ``CONFIG`` cut to ``TP_LAYERS`` of 36 layers in float32,
    ``TP_ROWS`` x ``TP_SEQ`` tokens; the plain model against its placement
    with ``act_pspec`` None and sequence-parallel (loss, every gradient
    leaf, the prefill logits, every parameter after two steps, each within
    1e-5 of the leaf's largest entry); step times and peaks; the dry-run
    of each placed cell on the 1 x 1 mesh against the card's bytes.  Slice
    15, the placed decode on the same mesh: (a) and (b) :func:`_tp_decode`,
    (c) :func:`_tp_compress` and (d) the dry-run of the placed decode cell
    (``TP_ROWS`` rows against ``TP_SEQ`` slots), whose parameter and state
    bytes must be the card's.  Returns the rANS kernel launches of the
    placed compress and decompress (the training launches none)."""
    import copy
    import torch
    import torch.distributed as dist
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data.pipeline import train_batch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (make_mesh_for, mesh_shape_for,
                                         mesh_shape_of)
    from repro_torch.models import init_model
    from repro_torch.parallel import sharding

    smi = _smi()
    over = dict(n_layers=TP_LAYERS, dtype="float32", attn_impl="naive",
                remat=False, grad_accum=1)
    base = get_config(TP_ARCH).with_(**over)
    _check(base.n_heads_padded == 32 and not base.kv_sharded
           and base.vocab_size == 151936, f"{TP_ARCH} geometry {base}")
    batch = train_batch(base, TP_ROWS, TP_SEQ, step=0)
    steps = [train_batch(base, TP_ROWS, TP_SEQ, step=i) for i in (1, 2)]
    what = (f"tensor parallel: {TP_ARCH} at full width, {TP_LAYERS} of 36 "
            f"layers (float32, naive attention), {TP_ROWS} x {TP_SEQ} "
            "tokens, mesh 1x1")
    reset_launches()
    _nccl_world1(dev)
    try:
        dm = make_mesh_for(1, device=dev)
        _check(tuple(dm.shape) == (1, 1)
               and mesh_shape_of(dm) == mesh_shape_for(1),
               f"make_mesh_for(1) gave {mesh_shape_of(dm)}")
        whole = init_model(base, seed=0, device=dev, draw="device")
        ref = _tp_run(copy.deepcopy(whole), batch, steps)
        out = {}
        for pspec in (None, TP_SP):
            whole.cfg = base.with_(act_pspec=pspec)
            try:
                placed = sharding.place_model(whole, dm)
            finally:
                whole.cfg = base
            o = _tp_run(placed, batch, steps, device_mesh=dm)
            del placed
            tag = f"act_pspec={pspec}"
            o["worst"] = {
                "loss": _tp_worst({"l": o["loss"]}, {"l": ref["loss"]},
                                  f"{what}, {tag}: loss"),
                "grads": _tp_worst(o["grads"], ref["grads"],
                                   f"{what}, {tag}: gradients"),
                "logits": _tp_worst({"l": o["logits"]},
                                    {"l": ref["logits"]},
                                    f"{what}, {tag}: prefill logits"),
                "params": _tp_worst(o["params"], ref["params"],
                                    f"{what}, {tag}: parameters after 2 "
                                    "steps")}
            for k in ("grads", "logits", "params"):
                o[k] = None
            out[pspec] = o
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        _check(not any(launches.values()), f"{what}: launched {launches}")
        dec_what = (f"placed decode: {TP_ARCH} at full width, {TP_LAYERS} of "
                    f"36 layers (float32), {TP_ROWS} rows x {TP_DEC_T} "
                    f"positions into a ring of {TP_SEQ}, mesh 1x1")
        dec = _tp_decode(dev, whole, dm, dec_what)
        del whole
        torch.cuda.empty_cache()
        cmp_what = (f"placed compress: ras-pimc CONFIG, {TP_PIMC[0]} lanes x "
                    f"{TP_PIMC[1]} tokens, chunk {TP_PIMC[2]}, mesh 1x1")
        cmp = _tp_compress(dev, dm, cmp_what)
    finally:
        dist.destroy_process_group()
    print(f"{what}: plain step {ref['ms']:.1f} ms, the step's own peak "
          f"{ref['own'] / 2**30:.2f} GiB ({ref['own']} B); loss "
          f"{float(ref['loss']):.6f} ({smi})", flush=True)
    shape = ShapeSpec(f"{TP_ROWS}x{TP_SEQ}", TP_SEQ, TP_ROWS, "train")
    for pspec, o in out.items():
        rec = dryrun.run_cell(TP_ARCH, shape, mesh=mesh_shape_for(1),
                              overrides={**over, "act_pspec": pspec},
                              verbose=False)
        _check(rec["status"] == "OK", f"{what}: dry-run "
               f"{rec.get('error')}")
        mem = rec["memory"]
        got = (mem["param_bytes"], mem["grad_bytes"], mem["optimizer_bytes"])
        want = (o["param_bytes"], o["grad_bytes"], o["moment_bytes"])
        _check(got == want, f"{what}: dry-run parameter, gradient and "
               f"moment bytes {got}, the card's {want}")
        w = o["worst"]
        print(f"{what}, placed with act_pspec={pspec}: loss, gradients, "
              f"prefill logits and parameters after 2 steps within "
              f"{w['loss']:.3e} / {w['grads']:.3e} / {w['logits']:.3e} / "
              f"{w['params']:.3e} of each leaf's largest entry of the "
              f"plain model's (limit 1e-5); step {o['ms']:.1f} ms, the "
              f"step's own peak {o['own'] / 2**30:.2f} GiB ({o['own']} B); "
              f"dry-run on the 1x1 mesh (compute) "
              f"{mem['total_bytes'] / 2**30:.2f} GiB ({mem['total_bytes']}"
              f" B; parameter, gradient and moment bytes equal to the "
              f"card's), ratio {mem['total_bytes'] / o['own']:.3f} ({smi})",
              flush=True)
    rec = dryrun.run_cell(TP_ARCH, ShapeSpec(f"decode {TP_ROWS}x{TP_SEQ}",
                                             TP_SEQ, TP_ROWS, "decode"),
                          mesh=mesh_shape_for(1), overrides=over,
                          verbose=False)
    _check(rec["status"] == "OK",
           f"{dec_what}: dry-run {rec.get('error')}")
    mem = rec["memory"]
    got = (mem["param_bytes"], mem["activation_bytes"])
    want = (dec["param_bytes"], dec["state_bytes"])
    _check(got == want, f"{dec_what}: dry-run parameter and state bytes "
           f"{got}, the card's {want}")
    print(f"{dec_what}: the step's ring layout {dec['layout']}; each "
          f"step's logits within {dec['worst']:.3e} of the plain model's "
          f"largest logit, the final state within "
          f"{dec['state_worst']:.3e} (limit 1e-5); "
          f"the placed prefill_chunk of {TP_DEC_PREFILL} positions bitwise "
          f"the placed steps; a step {dec['ms']:.3f} ms placed, "
          f"{dec['plain_ms']:.3f} ms plain (host wall, {TP_ROWS} rows); "
          f"dry-run of the placed decode cell on the 1x1 mesh (compute): "
          f"parameter and state bytes {got} equal to the card's, "
          f"{mem['total_bytes']} B in all ({smi})", flush=True)
    print(f"{cmp_what}: container byte-identical to the whole model's, "
          f"round trip exact, per-lane probes equal; compress "
          f"{cmp['comp']:.1f} / decompress {cmp['dec']:.1f} symbols/s; "
          f"launches {cmp['launches']} ({smi})", flush=True)
    return cmp["launches"]


# the recurrent families' compute placement: mamba2-130m CONFIG cut to
# RP_M2_LAYERS of 24 layers and recurrentgemma-2b CONFIG to one (rec, rec,
# attn) pattern, both in float32, trained rows x seq; the hybrid decodes
# RP_DEC_ROWS rows for RP_DEC_T positions into its 2,048-slot ring
RP_M2_LAYERS, RP_M2_ROWS, RP_M2_SEQ = 2, 2, 1024
RP_RG_LAYERS, RP_RG_ROWS, RP_RG_SEQ = 3, 1, 2048
RP_DEC_ROWS, RP_DEC_T = 2, 32


# the recurrent mixers' leaves of constant init (zeros and ones): every
# SSM head alike, every RG-LRU channel's gate biases alike
RECURRENT_CONSTANT = ("A_log", "D", "dt_bias", "norm_scale", "conv_x_b",
                      "conv_b_b", "conv_c_b", "conv_b", "gate_a_b",
                      "gate_i_b", "lam")


def _recurrent_perturb(model, seed: int) -> None:
    """Move the recurrent mixers' constant-init leaves
    (:data:`RECURRENT_CONSTANT`) off their inits by seeded draws of 0.1 x
    normal on the model's device: each head and channel then differs, so
    a placed rank that read another head's ``dt``, decay or ``D`` shows,
    and no leaf is a constant that two steps move by the learning rate
    alone."""
    import torch
    g = torch.Generator(device=model.embedding.device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] in RECURRENT_CONSTANT:
                p.add_(0.1 * torch.randn(p.shape, generator=g,
                                         device=p.device))


def _hybrid_placed_decode(dev, whole, what: str) -> None:
    """``whole`` (a full-width hybrid) and its placements on a world-1
    NCCL mesh 1 x 1 decode ``RP_DEC_ROWS`` rows of seeded tokens for
    ``RP_DEC_T`` positions into a ring of its ``local_window``: by default
    each step's logits and every state leaf bitwise the plain model's
    (the one rank's slab of the slots is the whole ring, attended as the
    unplaced step attends it); with ``slots_at_one`` the context-parallel
    ``slots`` step (the masked slab write, the slab's partials,
    ``softmax_combine``), within 1e-5 of the largest entry; the layout
    each step ran; the dry-run of the placed decode cell on the 1 x 1
    mesh at the card's parameter and state bytes."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_for, mesh_shape_for
    from repro_torch.parallel import sharding
    cfg, ring = whole.cfg, whole.cfg.local_window
    smi = _smi()
    rng = np.random.default_rng(30)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                       (RP_DEC_ROWS, RP_DEC_T)), device=dev)
    _nccl_world1(dev)
    try:
        dm = make_mesh_for(1, device=dev)
        models = {"plain": whole, "placed": sharding.place_model(whole, dm),
                  "slots": sharding.place_model(whole, dm,
                                                slots_at_one=True)}
        out = {}
        for name, m in models.items():
            st = m.init_state(RP_DEC_ROWS, ring)
            lgs = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(RP_DEC_T):
                lgs.append(m.decode_step(st, tok[:, t:t + 1], t))
            torch.cuda.synchronize()
            out[name] = dict(ms=1e3 * (time.perf_counter() - t0) / RP_DEC_T,
                             logits=lgs, state=st)
        layouts = {k: models[k].placement.serving(ring).ring
                   for k in ("placed", "slots")}
        _check(layouts == {"placed": "replicated", "slots": "slots"},
               f"{what}: the steps' ring layouts {layouts}")
        plain = out["plain"]
        _check(all(torch.equal(a, b) for a, b in zip(
            out["placed"]["logits"], plain["logits"])) and all(
            torch.equal(t, plain["state"].leaves()[k])
            for k, t in out["placed"]["state"].leaves().items()),
            f"{what}: the placed decode is not bitwise the plain model's")
        pl = models["slots"].placement
        worst = max(_tp_worst({"l": pl.whole_vocab(a)}, {"l": b},
                              f"{what}: slots step {t} logits")
                    for t, (a, b) in enumerate(zip(out["slots"]["logits"],
                                                   plain["logits"])))
        state_worst = _tp_worst(
            pl.unplace_state(out["slots"]["state"]).leaves(),
            plain["state"].leaves(), f"{what}: slots state")
        param_bytes = _nbytes(models["placed"].parameters())
        state_bytes = _nbytes(out["placed"]["state"].leaves().values())
        ms = {k: o["ms"] for k, o in out.items()}
        del models, out, plain
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    rec = dryrun.run_cell(cfg.name, ShapeSpec(
        f"decode {RP_DEC_ROWS}x{ring}", ring, RP_DEC_ROWS, "decode"),
        mesh=mesh_shape_for(1), overrides={"n_layers": cfg.n_layers,
                                           "dtype": cfg.dtype},
        verbose=False)
    _check(rec["status"] == "OK", f"{what}: dry-run {rec.get('error')}")
    mem = rec["memory"]
    got = (mem["param_bytes"], mem["activation_bytes"])
    _check(got == (param_bytes, state_bytes), f"{what}: dry-run parameter "
           f"and state bytes {got}, the card's {(param_bytes, state_bytes)}")
    print(f"{what}: {RP_DEC_ROWS} rows x {RP_DEC_T} positions into a ring "
          f"of {ring}; placed (the step's ring layout "
          f"{layouts['placed']!r}) each step's logits and every state leaf "
          f"bitwise the plain model's; with slots_at_one (layout "
          f"{layouts['slots']!r}) logits within {worst:.3e} and state "
          f"within {state_worst:.3e} of the largest entry (limit 1e-5); a "
          f"step {ms['plain']:.3f} / {ms['placed']:.3f} / {ms['slots']:.3f}"
          f" ms plain / placed / slots (host wall); dry-run of the placed "
          f"decode cell on the 1x1 mesh (compute): parameter and state "
          f"bytes {got} equal to the card's ({smi})", flush=True)


def recurrent_placed_phase(dev):
    """Slice 17: the recurrent families' compute placement at full width
    on a world-1 NCCL mesh 1 x 1.  ``mamba2-130m`` ``CONFIG`` cut to
    ``RP_M2_LAYERS`` of 24 layers and ``recurrentgemma-2b`` ``CONFIG`` cut
    to ``RP_RG_LAYERS`` of 26 (one (rec, rec, attn) pattern), in float32,
    drawn on the card, their constant-init leaves moved off
    (:func:`_recurrent_perturb`): each trained plain and then placed
    (:func:`_placed_train`), the hybrid's placed decode
    (:func:`_hybrid_placed_decode`).  No rANS kernel runs (counted)."""
    import torch
    from repro_torch.configs.mamba2_130m import CONFIG as M2
    from repro_torch.configs.recurrentgemma_2b import CONFIG as RG
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import init_model
    reset_launches()
    m2 = init_model(M2.with_(n_layers=RP_M2_LAYERS, dtype="float32"),
                    seed=0, device=dev, draw="device")
    _recurrent_perturb(m2, 1)
    _placed_train(dev, m2, f"mamba2 placed trainer: {RP_M2_LAYERS} of 24 "
                  f"layers (float32), {RP_M2_ROWS} x {RP_M2_SEQ} tokens",
                  rows=RP_M2_ROWS, seq=RP_M2_SEQ, rule=None)
    del m2
    torch.cuda.empty_cache()
    rg = init_model(RG.with_(n_layers=RP_RG_LAYERS, dtype="float32"),
                    seed=0, device=dev, draw="device")
    _recurrent_perturb(rg, 2)
    _placed_train(dev, rg, f"hybrid placed trainer: {RG.name} "
                  f"{RP_RG_LAYERS} of 26 layers (float32), {RP_RG_ROWS} x "
                  f"{RP_RG_SEQ} tokens", rows=RP_RG_ROWS, seq=RP_RG_SEQ,
                  rule=None)
    _hybrid_placed_decode(dev, rg, f"hybrid placed decode: {RG.name} "
                          f"{RP_RG_LAYERS} of 26 layers (float32)")
    del rg
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    _check(not any(launches.values()),
           f"recurrent placed: launched {launches}")


def topk_phase(dev):
    """The decode's first-index top-k (``predictors.model_topk_candidates``
    over ``topk_first``, a stable descending sort) on the card at the
    mixtral slice's rows (16 x 32,768): equal to the CPU's on built ties
    (all-zero and integer-valued rows, rows of -inf) and on BF16 logits,
    and with no host sync (the engine's cycles run it under
    ``set_sync_debug_mode("error")``), timed beside ``torch.topk`` (100
    calls between CUDA events)."""
    import numpy as np
    import torch
    from repro_torch.core.predictors import model_topk_candidates

    rng = np.random.default_rng(0)
    inf = np.full((TOPK_ROWS, TOPK_K), -np.inf, np.float32)
    inf[:, rng.integers(0, TOPK_K, 3)] = 0.0
    cases = [np.zeros((TOPK_ROWS, TOPK_K), np.float32),
             rng.integers(-3, 3, (TOPK_ROWS, TOPK_K)).astype(np.float32),
             inf]
    xs = [torch.as_tensor(x) for x in cases] + [torch.as_tensor(
        rng.normal(0, 2, (TOPK_ROWS, TOPK_K)).astype(np.float32)).to(
        torch.bfloat16)]
    for x in xs:
        got = model_topk_candidates(x.to(dev), TOPK).cpu()
        _check(torch.equal(got, model_topk_candidates(x, TOPK)),
               "top-k on the card differs from the CPU's")
    logits = xs[-1].to(dev)
    # the engine's cycles run it under this mode (no host sync in a cycle)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model_topk_candidates(logits, TOPK)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    n = 100
    ms = _median_ms(lambda: [model_topk_candidates(logits, TOPK)
                             for _ in range(n)], repeats=5) / n
    ms_t = _median_ms(lambda: [torch.topk(logits, TOPK, dim=-1).indices.to(
        torch.int32) for _ in range(n)], repeats=5) / n
    print(f"top-k: model_topk_candidates == CPU on {len(xs)} cases at "
          f"{TOPK_ROWS} x {TOPK_K} (ties, -inf, BF16); {ms:.4f} ms a call "
          f"(stable sort), torch.topk {ms_t:.4f} ms (BF16, top-{TOPK})",
          flush=True)


# --- phi3.5-moe at full width, cross attention and the encoder-decoder
# (slice 9) ----------------------------------------------------------------

# phi3.5-moe-42b-a6.6b at full width, its depth cut to 2 of 32 layers (2.60
# GB of BF16 weights a layer): 16 lanes x 256 token_stream(32064) tokens,
# chunk 128, prob_bits 16, top-4; one float32 layer card vs CPU
PHI_LAYERS = 2       # of 32 (4 before the tooling phases came)
PHI_LANES, PHI_T, PHI_CHUNK, PHI_BITS = 16, 256, 128, 16
# llama-3.2-vision-11b whole (40 layers) and seamless-m4t-large-v2 whole
# (24 + 24 layers) in BF16: greedy generate of 2 rows x a 16-token prompt +
# 32 new tokens at max_len 64, twice; card vs CPU in float32 at full width
# cut to one (attn, cross) pattern / one encoder and one dec layer, 4 decode
# steps of 2 rows and a 64-token forward, the vlm memory cut to 512 tokens;
# 2 BF16 train steps of 2 x 256 tokens from the end of the lr warmup (the
# vlm at one pattern, 5 of 40 layers: its AdamW state at full depth would
# be ~117 GB)
ED_ROWS, ED_PROMPT, ED_NEW, ED_MAX_LEN = 2, 16, 32, 64
ED_CPU_STEPS, ED_FWD_T, VLM_CPU_MEMORY = 4, 64, 512
ED_TRAIN_STEPS, ED_TRAIN_BATCH, ED_TRAIN_SEQ = 2, 2, 256
# the reference's make_train_step default: AdamW's first step moves every
# weight by about lr, and at 3e-3 the vlm's loss rose 12.55 -> 35.65 nats
# in one step (NVIDIA H100 80GB HBM3)
ED_TRAIN_LR = 3e-4
VLM_TRAIN_LAYERS = 5


def phi_phase(dev):
    """``phi3.5-moe-42b-a6.6b`` at full width, cut to ``PHI_LAYERS``
    layers (BF16, vocab 32,064 padded to 32,256, ``prob_bits=16``),
    through the kernel and coder backends (the SPC sees the 32,064 true
    symbols, never the padded tail); a 16-row step beside its byte bound;
    B6 and B2 at K = 32,064; one full-width layer in float32 against the
    CPU.  Returns the slice's launches and the kernel records."""
    import torch
    from repro_torch.configs.phi3_5_moe_42b_a6_6b import CONFIG
    from repro_torch.data.pipeline import token_stream
    from repro_torch.models import LM, init_model

    t0 = time.perf_counter()
    cfg = CONFIG.with_(n_layers=PHI_LAYERS)
    model = init_model(cfg, seed=0, device=dev, draw="device")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    tokens = token_stream(cfg.vocab_size, (PHI_LANES, PHI_T), seed=0)
    run = _zoo_slice(model, tokens, PHI_CHUNK, PHI_BITS, "phi")
    k_in = {run["b6_pos"][0].shape[-1], run["b6_batch"][0].shape[-1]}
    _check(k_in == {cfg.vocab_size} and cfg.vocab_padded > cfg.vocab_size,
           f"phi: B6 saw K = {k_in}, not the {cfg.vocab_size} true symbols")
    n = PHI_LANES * PHI_T
    print(f"phi: {cfg.name} at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads x {cfg.head_dim_}, kv {cfg.n_kv_heads}, d_ff "
          f"{cfg.d_ff}, {cfg.n_experts} experts top-{cfg.topk_experts}, vocab"
          f" {cfg.vocab_size} padded to {cfg.vocab_padded}, {cfg.dtype}, "
          f"untied head), depth cut to {cfg.n_layers} of {CONFIG.n_layers} "
          f"layers ({n_params} parameters, drawn on the card in "
          f"{t_init:.1f} s), {PHI_LANES} lanes x {PHI_T} tokens, chunk "
          f"{PHI_CHUNK}, prob_bits {PHI_BITS}: round trip bit-exact, kernel "
          f"and coder containers byte-identical, per-lane probes equal; B6 "
          f"at K = {cfg.vocab_size}; launches {run['launches']}; no plain "
          "SPC call on the card", flush=True)
    print(f"phi: bits/symbol {run['bits']:.4f}, model xent "
          f"{run['xent']:.4f} bits, avg probes/symbol "
          f"{run['avg_probes']:.4f}, container {len(run['blob'])} bytes; "
          f"compress {n / run['t_comp']:.1f} symbols/s "
          f"({run['t_comp']:.3f} s), decompress {n / run['t_dec']:.1f} "
          f"symbols/s ({run['t_dec']:.3f} s); peak memory "
          f"{run['peak'] / 2**30:.2f} GiB", flush=True)
    _mx_step(dev, model, PHI_LANES, PHI_T, "phi")
    recs = _alone(functools.partial(_zoo_kernels, dict(run), PHI_BITS,
                                    "phi"))
    del run["b6_batch"], run["b6_pos"], run["b2_pop"]
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    placed = _placed_serve(dev, model, "experts", PHI_BITS,
                               f"phi placed: {cfg.n_layers} of "
                               f"{CONFIG.n_layers} layers ({cfg.dtype})")
    del model
    torch.cuda.empty_cache()
    t_placed = time.perf_counter() - t1
    one = CONFIG.with_(n_layers=1, dtype="float32")
    card = init_model(one, seed=1, device=dev, draw="device")
    cpu = LM(one)
    cpu.load_state_dict(card.state_dict())
    _zoo_card_vs_cpu(cpu, card, ED_ROWS, ED_CPU_STEPS,
                     "phi: one full-width layer in float32")
    del cpu
    t1 = time.perf_counter()
    _placed_train(dev, card, f"phi placed trainer: 1 of "
                      f"{CONFIG.n_layers} layers (float32), "
                      f"{MOE_TRAIN_ROWS} x {MOE_TRAIN_SEQ} tokens")
    del card
    torch.cuda.empty_cache()
    t_placed += time.perf_counter() - t1
    print(f"phi placed: {t_placed:.1f} s", flush=True)
    print(f"phi slice: {time.perf_counter() - t0:.1f} s", flush=True)
    return run["launches"], recs, placed


def _ed_inputs(cfg, rows: int, seq: int, dev, seed: int = 0):
    """``train_batch``'s tokens and its memory or encoder-input plane on
    the card, the plane in the model's dtype: (tokens, memory or None,
    enc_inputs or None)."""
    import torch
    from repro_torch.data.pipeline import train_batch
    from repro_torch.models.transformer import torch_dtype

    b = train_batch(cfg, rows, seq, seed=seed)

    def put(k):
        return None if k not in b else torch.as_tensor(b[k]).to(
            dev, torch_dtype(cfg))

    return (torch.as_tensor(b["tokens"], dtype=torch.int64, device=dev),
            put("memory"), put("enc_inputs"))


def _ed_serve(model, prompt, memory, what: str, cross_flops: float):
    """Greedy ``generate`` twice on the card (``ED_NEW`` new tokens at
    ``ED_MAX_LEN``): identical tokens, finite logits; a step's median time
    beside the bytes of weights it reads and the FLOPs of its memory
    projections."""
    import torch
    from repro_torch.models import decode_step, init_state
    from repro_torch.serve.engine import generate

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, lgs = generate(model, prompt, ED_NEW, ED_MAX_LEN, memory=memory,
                        return_logits=True)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    again = generate(model, prompt, ED_NEW, ED_MAX_LEN, memory=memory)
    _check(torch.equal(out, again), f"{what}: two generate runs differ")
    _check(bool(torch.isfinite(lgs).all()), f"{what}: non-finite logits")
    rows = prompt.shape[0]
    state = init_state(model, rows, ED_MAX_LEN)
    tok = prompt[:, :1]
    step_ms = _median_ms(lambda: decode_step(model, state, tok, 0,
                                             memory=memory), repeats=10)
    from repro_torch.analysis.roofline import HBM_BYTES_PER_S, PEAK_FLOPS
    bf16_flops_per_s = PEAK_FLOPS["bfloat16"]
    moved = _step_bytes(model, rows) + memory.numel() * memory.element_size()
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_flops = cross_flops / bf16_flops_per_s * 1e3
    n_steps = prompt.shape[1] + ED_NEW - 1
    print(f"{what}: generate {rows} rows x {prompt.shape[1]} prompt + "
          f"{ED_NEW} new tokens (max_len {ED_MAX_LEN}) in {t_gen:.3f} s "
          f"({1e3 * t_gen / n_steps:.3f} ms a step over {n_steps} steps); "
          f"two runs give identical tokens, logits finite; model step "
          f"{step_ms:.3f} ms ({rows} rows) against a byte bound of "
          f"{t_bytes:.3f} ms ({moved} B: the weights and the memory) and "
          f"{t_flops:.3f} ms for the {cross_flops:.4g} FLOP of the memory's "
          f"K/V projections at {bf16_flops_per_s:.4g} FLOP/s", flush=True)
    return out


def _ed_card_vs_cpu(cfg, dev, memory_cpu, what: str):
    """``cfg`` (a float32 cut) drawn on the card and copied to the CPU:
    ``ED_CPU_STEPS`` decode steps of 2 rows and an ``ED_FWD_T``-token
    forward against ``memory_cpu`` (or, for an encoder-decoder, the
    memory each side encodes from the same inputs), logits within 1e-4;
    the encoder's output too.  Returns the card's model."""
    import torch
    from repro_torch.models import LM, encode_memory, init_model

    card = init_model(cfg, seed=1, device=dev, draw="device")
    cpu = LM(cfg)
    cpu.load_state_dict(card.state_dict())
    models = (cpu, card)
    if cfg.is_encdec:
        with torch.no_grad():
            mems = [encode_memory(m, memory_cpu.to(m.embedding.device))
                    for m in models]
        err = float((mems[1].cpu() - mems[0]).abs().max())
        _check(bool(torch.isfinite(mems[1]).all()) and err <= 1e-4,
               f"{what}: encoder output differs from the CPU's by {err}")
        print(f"{what}: encode_memory of {tuple(memory_cpu.shape)}, card vs "
              f"CPU: max abs diff {err:.3e} (tolerance 1e-4)", flush=True)
        memory_cpu = mems[0]
    _zoo_card_vs_cpu(cpu, card, ED_ROWS, ED_CPU_STEPS, what,
                     memory=memory_cpu[:ED_ROWS])
    toks = torch.randint(0, cfg.vocab_size, (1, ED_FWD_T),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        lg = [m._logits(m(toks.to(m.embedding.device),
                          memory=memory_cpu[:1].to(m.embedding.device))[0])
              for m in models]
    err = float((lg[1].cpu() - lg[0]).abs().max())
    _check(bool(torch.isfinite(lg[1]).all()) and err <= 1e-4,
           f"{what}: forward logits differ from the CPU's by {err}")
    print(f"{what}: {ED_FWD_T}-token forward, card vs CPU: max abs logit "
          f"diff {err:.3e} (tolerance 1e-4)", flush=True)
    return card


def _ed_train(cfg, dev, what: str, arch: str):
    """``ED_TRAIN_STEPS`` BF16 train steps of ``ED_TRAIN_BATCH`` x
    ``ED_TRAIN_SEQ`` tokens and their memory planes (``train_batch``'s
    float32 draws, which the step casts to BF16) from the end of the lr
    warmup, two microbatches a step: finite losses, the step time and the
    peak memory.  Returns the trainer's cell record
    (:func:`_train_record`)."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import train_batch
    from repro_torch.models import init_model
    from repro_torch.train import train_loop

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = init_model(cfg, seed=2, device=dev, draw="device")
    state = train_loop.init_train_state(model)
    state = state._replace(step=torch.full_like(state.step, ZOO_M2_WARM))
    step = train_loop.make_train_step(cfg.with_(grad_accum=2),
                                      base_lr=ED_TRAIN_LR)
    losses, secs = [], []
    with _grad_bytes() as grads:
        for i in range(ED_TRAIN_STEPS):
            batch = train_batch(cfg, ED_TRAIN_BATCH, ED_TRAIN_SEQ, step=i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    record = _train_record(
        arch, what, ED_TRAIN_BATCH, ED_TRAIN_SEQ,
        {"grad_accum": 2, "n_layers": cfg.n_layers}, state, grads, peak)
    _check(np.isfinite(losses).all(), f"{what} losses {losses}")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{what}: {cfg.n_layers} layers ({n_params} parameters, "
          f"{cfg.dtype}), {ED_TRAIN_STEPS} steps of {ED_TRAIN_BATCH} x "
          f"{ED_TRAIN_SEQ} tokens (2 microbatches) from step {ZOO_M2_WARM}:"
          f" losses {', '.join(f'{x:.4f}' for x in losses)} nats (ln vocab "
          f"{math.log(cfg.vocab_size):.4f}); step {1e3 * secs[-1]:.1f} ms "
          f"(the first {1e3 * secs[0]:.1f} ms); peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    state = _without_remat(state, cfg.with_(grad_accum=2), batch,
                           ED_TRAIN_LR, what, 1e3 * secs[-1], peak)
    del model, state, step
    torch.cuda.empty_cache()
    return record


# cross attention's and the encoder-decoder's compute placement on the
# world-1 NCCL mesh 1 x 1, with the card-vs-CPU cuts: trained plain and
# placed on ED_PLACED_ROWS x ED_PLACED_SEQ train_batch tokens (and their
# memory or encoder-input plane), and a greedy decode of ED_ROWS rows for
# ED_PLACED_T positions against a memory
ED_PLACED_ROWS, ED_PLACED_SEQ, ED_PLACED_T = 2, 256, 32
ED_CONSTANT = ("ln1", "ln2", "ln_cross", "final_norm")


def _ed_placed(dev, model, what: str, overrides: dict) -> None:
    """``model`` (a vlm or audio float32 cut on the card, its norm
    scales moved off their ones by seeded draws) placed for compute on
    the world-1 mesh: trained plain and then placed
    (:func:`_placed_train`, the dry-run of the train cell at the cut's
    ``overrides``), then the placed greedy decode
    (:func:`_ed_placed_decode`)."""
    import torch
    g = torch.Generator(device=model.embedding.device).manual_seed(3)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] in ED_CONSTANT:
                p.add_(0.1 * torch.randn(p.shape, generator=g,
                                         device=p.device))
    _placed_train(dev, model, f"{what} trainer, {ED_PLACED_ROWS} x "
                  f"{ED_PLACED_SEQ} tokens", rows=ED_PLACED_ROWS,
                  seq=ED_PLACED_SEQ, rule=None, overrides=overrides)
    torch.cuda.empty_cache()
    _ed_placed_decode(dev, model, f"{what} decode", overrides)


def _ed_placed_decode(dev, whole, what: str, overrides: dict) -> None:
    """``whole`` and its placements on a world-1 NCCL mesh 1 x 1 each
    decode ``ED_ROWS`` rows greedily for ``ED_PLACED_T`` positions from
    seeded first tokens against a ``train_batch`` memory (an
    encoder-decoder's: each model's ``encode_memory`` of the same encoder
    inputs, the placed encoder's bitwise the plain one's): by default
    each step's logits, the memory and every state leaf bitwise the plain
    model's; with ``slots_at_one`` (the context-parallel ``slots`` step
    where the ring's slots are placed) within 1e-5 of the largest entry;
    the generated tokens equal; the layout each step ran; the dry-run of
    the placed decode cell on the 1 x 1 mesh at the card's parameter and
    state bytes."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_for, mesh_shape_for
    from repro_torch.models import encode_memory
    from repro_torch.parallel import sharding
    cfg, n = whole.cfg, ED_PLACED_T
    smi = _smi()
    rng = np.random.default_rng(31)
    first = torch.as_tensor(rng.integers(0, cfg.vocab_size, (ED_ROWS, 1)),
                            device=dev)
    _, memory, enc = _ed_inputs(cfg, ED_ROWS, n, dev, seed=3)
    _nccl_world1(dev)
    try:
        dm = make_mesh_for(1, device=dev)
        models = {"plain": whole, "placed": sharding.place_model(whole, dm),
                  "slots": sharding.place_model(whole, dm,
                                                slots_at_one=True)}
        out = {}
        for name, m in models.items():
            pl = m.placement
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mem = memory
            if enc is not None:
                with torch.no_grad():
                    mem = encode_memory(m, enc)
            st = m.init_state(ED_ROWS, n)
            tok, lgs, toks = first, [], []
            for t in range(n):
                lg = m.decode_step(st, tok, t, memory=mem)
                lg = lg if pl is None else pl.whole_vocab(lg)
                tok = lg[:, :cfg.vocab_size].argmax(-1, keepdim=True)
                lgs.append(lg)
                toks.append(tok)
            torch.cuda.synchronize()
            out[name] = dict(ms=1e3 * (time.perf_counter() - t0) / n,
                             logits=lgs, tokens=torch.cat(toks, 1),
                             memory=mem, state=st)
        layouts = {k: models[k].placement.serving(n).ring
                   for k in ("placed", "slots")}
        plain, placed = out["plain"], out["placed"]
        _check(torch.equal(placed["memory"], plain["memory"])
               and all(torch.equal(a, b) for a, b in zip(placed["logits"],
                                                         plain["logits"]))
               and all(torch.equal(t, plain["state"].leaves()[k])
                       for k, t in placed["state"].leaves().items()),
               f"{what}: the placed decode is not bitwise the plain "
               "model's")
        pl = models["slots"].placement
        worst = max(_tp_worst({"l": a}, {"l": b},
                              f"{what}: slots_at_one step {t} logits")
                    for t, (a, b) in enumerate(zip(out["slots"]["logits"],
                                                   plain["logits"])))
        state_worst = _tp_worst(
            pl.unplace_state(out["slots"]["state"]).leaves(),
            plain["state"].leaves(), f"{what}: slots_at_one state")
        _check(all(torch.equal(o["tokens"], plain["tokens"])
                   for o in out.values()),
               f"{what}: the greedy tokens differ between the placements")
        param_bytes = _nbytes(models["placed"].parameters())
        state_bytes = _nbytes(placed["state"].leaves().values())
        ms = {k: o["ms"] for k, o in out.items()}
        del models, out, plain, placed
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    rec = dryrun.run_cell(cfg.name, ShapeSpec(f"decode {ED_ROWS}x{n}", n,
                                              ED_ROWS, "decode"),
                          mesh=mesh_shape_for(1), overrides={
                              "n_layers": cfg.n_layers, "dtype": cfg.dtype,
                              **overrides}, verbose=False)
    _check(rec["status"] == "OK", f"{what}: dry-run {rec.get('error')}")
    mem = rec["memory"]
    got = (mem["param_bytes"], mem["activation_bytes"])
    _check(got == (param_bytes, state_bytes), f"{what}: dry-run parameter "
           f"and state bytes {got}, the card's {(param_bytes, state_bytes)}")
    print(f"{what}: {ED_ROWS} rows x {n} positions greedy against the "
          f"memory; placed (the step's ring layout {layouts['placed']!r}) "
          f"each step's logits, the memory and every state leaf bitwise "
          f"the plain model's; with slots_at_one (layout "
          f"{layouts['slots']!r}) logits within {worst:.3e} and state "
          f"within {state_worst:.3e} of the largest entry (limit 1e-5); "
          f"the generated tokens equal; a step {ms['plain']:.3f} / "
          f"{ms['placed']:.3f} / {ms['slots']:.3f} ms plain / placed / "
          f"slots (host wall, the memory's encoding included); dry-run of "
          f"the placed decode cell on the 1x1 mesh: parameter and state "
          f"bytes {got} equal to the card's ({smi})", flush=True)


def vlm_phase(dev):
    """``llama-3.2-vision-11b`` whole (40 layers: 8 x (4 ``attn`` + 1
    ``cross``), BF16, drawn on the card) against a (2, 4,096, 4,096) BF16
    memory: greedy generation twice (identical tokens), a step's time
    beside its bounds; one (attn, cross) pattern at full width in float32
    against the CPU (memory cut to ``VLM_CPU_MEMORY`` tokens); BF16 train
    steps at ``VLM_TRAIN_LAYERS`` layers (their cell record is returned,
    :func:`_train_record`)."""
    import torch
    from repro_torch.configs.llama_3_2_vision_11b import CONFIG
    from repro_torch.models import init_model

    t0 = time.perf_counter()
    model = init_model(CONFIG, seed=0, device=dev, draw="device")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"vlm: {CONFIG.name} whole ({CONFIG.n_layers} layers, "
          f"{model.kinds.count('cross')} cross, d_model {CONFIG.d_model}, "
          f"{CONFIG.n_heads} heads x {CONFIG.head_dim_} over "
          f"{CONFIG.n_kv_heads} kv heads, vocab {CONFIG.vocab_size}, "
          f"{CONFIG.dtype}; {n_params} parameters drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    prompt, memory, _ = _ed_inputs(CONFIG, ED_ROWS, ED_PROMPT, dev)
    kv = CONFIG.n_kv_heads * CONFIG.head_dim_
    flops = (2 * 2 * model.kinds.count("cross") * memory.shape[0]
             * memory.shape[1] * CONFIG.d_model * kv)
    _ed_serve(model, prompt, memory, "vlm", flops)
    del model, memory
    torch.cuda.empty_cache()
    cut = CONFIG.with_(n_layers=2, cross_attn_every=2, dtype="float32")
    mem = torch.randn((ED_ROWS, VLM_CPU_MEMORY, CONFIG.d_model),
                      generator=torch.Generator().manual_seed(2)) * 0.02
    card = _ed_card_vs_cpu(cut, dev, mem, "vlm: one (attn, cross) pattern "
                           f"at full width in float32, memory "
                           f"{VLM_CPU_MEMORY} tokens")
    t1 = time.perf_counter()
    _ed_placed(dev, card, "vlm placed: one (attn, cross) pattern (float32)",
               {"cross_attn_every": 2})
    del card
    torch.cuda.empty_cache()
    print(f"vlm placed: {time.perf_counter() - t1:.1f} s", flush=True)
    record = _ed_train(CONFIG.with_(n_layers=VLM_TRAIN_LAYERS), dev,
                       "vlm trainer", "llama-3.2-vision-11b")
    print(f"vlm: {time.perf_counter() - t0:.1f} s", flush=True)
    return record


def audio_phase(dev):
    """``seamless-m4t-large-v2`` whole (24 encoder + 24 ``dec`` layers,
    BF16): its (2, 1,024, 1,024) encoder inputs through ``encode_memory``,
    then greedy generation twice against that memory; one encoder and one
    ``dec`` layer at full width in float32 against the CPU; BF16 train
    steps at full depth."""
    import torch
    from repro_torch.configs.seamless_m4t_large_v2 import CONFIG
    from repro_torch.models import encode_memory, init_model

    t0 = time.perf_counter()
    model = init_model(CONFIG, seed=0, device=dev, draw="device")
    n_params = sum(p.numel() for p in model.parameters())
    prompt, _, enc = _ed_inputs(CONFIG, ED_ROWS, ED_PROMPT, dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.no_grad():
        memory = encode_memory(model, enc)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t1
    _check(bool(torch.isfinite(memory).all()), "audio: non-finite memory")
    print(f"audio: {CONFIG.name} whole ({CONFIG.encoder_layers} encoder + "
          f"{CONFIG.n_layers} dec layers, d_model {CONFIG.d_model}, "
          f"{CONFIG.n_heads} heads x {CONFIG.head_dim_}, vocab "
          f"{CONFIG.vocab_size}, {CONFIG.dtype}; {n_params} parameters drawn "
          f"on the card); encode_memory of {tuple(enc.shape)} in "
          f"{1e3 * t_enc:.1f} ms", flush=True)
    kv = CONFIG.n_kv_heads * CONFIG.head_dim_
    flops = (2 * 2 * CONFIG.n_layers * memory.shape[0] * memory.shape[1]
             * CONFIG.d_model * kv)
    _ed_serve(model, prompt, memory, "audio", flops)
    del model, memory, enc
    torch.cuda.empty_cache()
    cut = CONFIG.with_(n_layers=1, encoder_layers=1, dtype="float32")
    enc_cpu = torch.randn((ED_ROWS, CONFIG.memory_tokens, CONFIG.d_model),
                          generator=torch.Generator().manual_seed(2)) * 0.02
    card = _ed_card_vs_cpu(cut, dev, enc_cpu, "audio: one encoder and one "
                           "dec layer at full width in float32")
    t1 = time.perf_counter()
    _ed_placed(dev, card, "audio placed: one encoder and one dec layer "
               "(float32)", {"encoder_layers": 1})
    del card
    torch.cuda.empty_cache()
    print(f"audio placed: {time.perf_counter() - t1:.1f} s", flush=True)
    _ed_train(CONFIG, dev, "audio trainer", "seamless-m4t-large-v2")
    print(f"audio: {time.perf_counter() - t0:.1f} s", flush=True)


# the tooling phases: the fault-tolerant trainer and the launchers, the
# BF16 checkpoint, the examples and the lane and chunk sweeps
# (100 and 20 steps before the remat phase came, cut for the script's time
# limit)
TRAINER_STEPS, TRAINER_SAVE_EVERY, TRAINER_FAULT = 50, 25, 30
LAUNCH_STEPS, LAUNCH_SAVE_EVERY = 10, 5


def _quiet(fn, *args, what: str):
    """``fn(*args)`` with its standard output captured, then printed with
    ``what`` before each line; returns ``(result, the output)``."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    text = buf.getvalue()
    for line in text.strip().splitlines():
        print(f"{what}: {line}", flush=True)
    return out, text


def _states_equal(a, b) -> bool:
    """Two port train states hold the same parameters, moments and steps,
    bit for bit."""
    import torch
    return (all(bool(torch.equal(x, y)) for x, y in zip(
        a.model.parameters(), b.model.parameters()))
        and all(bool(torch.equal(a.opt.m[k], b.opt.m[k]))
                and bool(torch.equal(a.opt.v[k], b.opt.v[k]))
                for k in a.opt.m)
        and int(a.step) == int(b.step) and int(a.opt.step) == int(b.opt.step))


def _checkpoint_round_trip(state, fresh, step: int, what: str) -> dict:
    """``state`` saved (blocking) and restored into ``fresh`` on the card,
    which must then equal it bit for bit; the seconds of each and the npz
    bytes."""
    import os
    import tempfile
    import torch
    from repro_torch.train import checkpoint

    with tempfile.TemporaryDirectory() as d:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = checkpoint.save(d, step, state)
        t_save = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(path, "host0.npz"))
        _check(checkpoint.latest_step(d) == step, f"{what}: latest_step")
        t0 = time.perf_counter()
        checkpoint.restore(d, step, fresh)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
    _check(_states_equal(state, fresh), f"{what}: the restored state "
           "differs from the saved one")
    return dict(save_s=t_save, restore_s=t_restore, bytes=nbytes)


def trainer_phase(dev):
    """The slice's path: ``examples/train_small_lm.run`` at ``ras-pimc``'s
    full width (``CONFIG``), ``TRAINER_STEPS`` steps of 16 x 128 under the
    ``RestartManager`` (a checkpoint every ``TRAINER_SAVE_EVERY`` steps,
    one fault injected before step ``TRAINER_FAULT``), then the held-out
    8 x 256 tokens through the kernel backend with the launch counters set
    to 0 before the run and read after it (training and the coder backend
    launch no kernel): exactly B1 1, B2 T, B6 T + 1.  The restart count is
    1, the final parameters and moments equal an unbroken run's bit for
    bit, and the full-width state saves and restores bitwise.  Returns the
    launches."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs.ras_pimc import CONFIG
    from repro_torch.examples import train_small_lm as ex
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import init_model
    from repro_torch.train import train_loop

    reset_launches()
    t0 = time.perf_counter()
    rec = ex.run(CONFIG, TRAINER_STEPS, dev, save_every=TRAINER_SAVE_EVERY,
                 fault_at=TRAINER_FAULT)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    _check(launches == _only(rans_encode_lanes=1, rans_decode_step=ex.T,
                             spc_quantize=ex.T + 1),
           f"trainer: launch counts {launches}")
    replayed = TRAINER_FAULT % TRAINER_SAVE_EVERY
    _check(rec["failures"] == 1, f"trainer: {rec['failures']} restarts, "
           "one fault injected")
    _check(len(rec["losses"]) == TRAINER_STEPS + replayed,
           f"trainer: {len(rec['losses'])} steps run, expected "
           f"{TRAINER_STEPS} + {replayed} replayed")
    losses = np.asarray(rec["losses"])
    _check(np.isfinite(losses).all() and losses[-10:].mean()
           < losses[:10].mean(), f"trainer: loss did not fall {losses}")
    state = rec["state"]
    with tempfile.TemporaryDirectory() as d:
        clean, mgr, _, _ = ex.train(CONFIG, TRAINER_STEPS, dev, d,
                                    save_every=TRAINER_SAVE_EVERY)
    _check(mgr.failures == 0 and int(state.step) == TRAINER_STEPS,
           f"trainer: step {int(state.step)}")
    _check(_states_equal(state, clean), "trainer: the run with a fault "
           "differs from the unbroken run")
    fresh = train_loop.init_train_state(init_model(
        CONFIG.with_(grad_accum=1), seed=1, device=dev))
    ck = _checkpoint_round_trip(state, fresh, TRAINER_STEPS, "trainer")
    secs = np.asarray(rec["step_s"][1:]) * 1e3
    print(f"trainer: {CONFIG.name} at full width ({CONFIG.n_layers} layers, "
          f"d_model {CONFIG.d_model}, {CONFIG.dtype}), {TRAINER_STEPS} "
          f"steps of {ex.BATCH} x {ex.SEQ} at lr {ex.LR}, a checkpoint "
          f"every {TRAINER_SAVE_EVERY}, one fault before step "
          f"{TRAINER_FAULT}: {rec['failures']} restart, {replayed} steps "
          f"replayed from step {TRAINER_FAULT - replayed}; parameters and "
          f"moments bitwise equal to the unbroken run", flush=True)
    print(f"trainer: losses (nats) "
          f"{', '.join(f'{x:.4f}' for x in losses[::TRAINER_SAVE_EVERY])}"
          f" ... {losses[-1]:.4f}; step {statistics.median(secs):.2f} ms "
          f"(median; p90 {np.percentile(secs, 90):.2f} ms; the first "
          f"{rec['step_s'][0] * 1e3:.1f} ms); run with the held-out coding "
          f"{t_run:.1f} s", flush=True)
    print(f"trainer: checkpoint of the full-width state {ck['bytes']} bytes "
          f"(35 leaves), save {ck['save_s']:.3f} s, restore "
          f"{ck['restore_s']:.3f} s, bitwise", flush=True)
    print(f"trainer: held-out {ex.LANES} x {ex.T}: CR {rec['cr_lm']:.4f} "
          f"against the static histogram's {rec['cr_hist']:.4f}, "
          f"{rec['bits_per_symbol']:.4f} bits/symbol (model xent "
          f"{rec['model_xent_bits']:.4f}), {rec['probes']:.2f} probes/symbol;"
          f" kernel and coder containers byte-identical, decode bit-exact; "
          f"compress {rec['compress_s']:.2f} s, decompress "
          f"{rec['decompress_s']:.2f} s; launches {launches}", flush=True)
    return launches


def launchers_phase(dev):
    """``launch.train.main`` (``LAUNCH_STEPS`` steps, a checkpoint every
    ``LAUNCH_SAVE_EVERY``) then ``launch.serve.main --ckpt --backend
    kernel`` on its directory, in process: the server restores the last
    step, round-trips bit-exactly, and its launches between a counter
    reset and read are B1 1, B2 256, B6 257 (its 8 x 256 stream).
    Returns them."""
    import os
    import tempfile
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import serve, train
    from repro_torch.train import checkpoint

    with tempfile.TemporaryDirectory() as d:
        state, _ = _quiet(train.main, ["--ckpt", d, "--steps",
                                       str(LAUNCH_STEPS), "--save-every",
                                       str(LAUNCH_SAVE_EVERY)],
                          what="launch.train")
        steps = range(LAUNCH_SAVE_EVERY, LAUNCH_STEPS + 1, LAUNCH_SAVE_EVERY)
        _check(int(state.step) == LAUNCH_STEPS and sorted(os.listdir(d))
               == [f"step_{s:08d}" for s in steps],
               f"launch.train: checkpoints {sorted(os.listdir(d))}")
        _check(checkpoint.latest_step(d) == LAUNCH_STEPS,
               "launch.train: latest step")
        reset_launches()
        _, out = _quiet(serve.main, ["--ckpt", d, "--backend", "kernel"],
                        what="launch.serve")
        launches = dict(LAUNCHES)
    _check(f"restored checkpoint step {LAUNCH_STEPS}" in out,
           "launch.serve did not restore the checkpoint")
    _check("bit-exact roundtrip: True" in out, "launch.serve round trip")
    _check(launches == _only(rans_encode_lanes=1, rans_decode_step=256,
                             spc_quantize=257),
           f"launch.serve: launch counts {launches}")
    print(f"launchers: launch.train wrote steps {LAUNCH_SAVE_EVERY}.."
          f"{LAUNCH_STEPS}; launch.serve --ckpt restored step "
          f"{LAUNCH_STEPS} and round-tripped bit-exactly; launches "
          f"{launches}", flush=True)
    return launches


def bf16_checkpoint_phase(dev, state):
    """The ``mamba2-130m`` full-width BF16 train state of
    ``mamba2_train_phase`` saved and restored into a fresh state on the
    card, bitwise.  The restore reads each BF16 parameter from a ``|V2``
    leaf by bit pattern (it refuses any other dtype for a BF16 tensor)."""
    from repro_torch.models import init_model
    from repro_torch.train import train_loop

    cfg = state.model.cfg
    fresh = train_loop.init_train_state(init_model(cfg, seed=1, device=dev,
                                                   draw="device"))
    ck = _checkpoint_round_trip(state, fresh, int(state.step),
                                "BF16 checkpoint")
    n = sum(p.numel() for p in state.model.parameters())
    print(f"BF16 checkpoint: {cfg.name} at full width ({n} parameters, "
          f"{cfg.dtype}, moments {state.opt.m['embedding'].dtype}), step "
          f"{int(state.step)}: {ck['bytes']} bytes, save {ck['save_s']:.3f} "
          f"s, restore {ck['restore_s']:.3f} s; every leaf bitwise, the "
          f"parameters read from |V2 leaves", flush=True)


def examples_phase(dev):
    """``examples/quickstart``, ``compress_images`` and ``compress_latents``
    (the Fig. 4(c) VAE's 300 steps, not the example's 600, for the
    script's time) in process on the card with all their checks, each
    with the launch counters set to 0 before it and read after: none,
    B1 1 and B3 1 (the image's encode and decode), and the VAE's B2 pops
    (2 d_z per kernel ``bb_encode``, 2 d_z + d_x per kernel ``bb_decode``)
    with B6 4 per ``bb_encode``/``bb_decode`` (its tables, either pop
    backend).  Returns the phase's launches."""
    from repro_torch.examples import (compress_images, compress_latents,
                                      quickstart)
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import vae

    vcfg = vae.VAEConfig(d_x=compress_latents.D_X)
    want = {
        "quickstart": ((quickstart.run, dev), _only()),
        "compress_images": ((compress_images.run, dev), _only(
            rans_encode_lanes=1, rans_decode_lanes=1)),
        "compress_latents": ((compress_latents.run, FIG4C_VAE_STEPS, dev),
                             _only(rans_decode_step=4 * vcfg.d_z + vcfg.d_x,
                                   spc_quantize=16)),
    }
    total = _only()
    for name, ((fn, *args), counts) in want.items():
        reset_launches()
        t0 = time.perf_counter()
        _quiet(fn, *args, what=name)
        secs = time.perf_counter() - t0
        got = dict(LAUNCHES)
        _check(got == counts, f"{name}: launch counts {got}")
        total = {k: total[k] + got[k] for k in total}
        print(f"examples: {name} passed on the card in {secs:.1f} s; "
              f"launches {got}", flush=True)
    return total


def lanes_phase(dev):
    """``benchmarks/bench_lanes.run`` at its defaults (T 1,024, lanes 8 /
    32 / 128, chunk 256) on the card, one timed call per path: the coder
    and B1 byte-identical, B4's zero-copy decode exact, the container bytes
    equal to the committed ``BENCH_lanes.json``; Msym/s per lane count.
    Returns the launches (B1 and B4 once per lane count)."""
    from repro_torch.benchmarks import bench_lanes
    from repro_torch.kernels import LAUNCHES, reset_launches

    committed = json.loads((ROOT / "BENCH_lanes.json").read_text())
    reset_launches()
    pts = bench_lanes.run(device=dev, warmup=False)
    launches = dict(LAUNCHES)
    _check([p["container_bytes"] for p in pts]
           == [p["container_bytes"] for p in committed]
           == [8599, 33851, 138574],
           "bench_lanes: container bytes "
           f"{[p['container_bytes'] for p in pts]}")
    _check(all(p["backends_byte_identical"] for p in pts),
           "bench_lanes: backends")
    n = len(pts)
    _check(launches == _only(rans_encode_lanes=n, rans_decode_slab=n),
           f"bench_lanes: launch counts {launches}")
    for p in pts:
        print(f"lanes={p['lanes']}: coder enc {p['coder_encode_Msym_s']:.4f}"
              f" / dec {p['coder_decode_Msym_s']:.4f} Msym/s, B1 enc "
              f"{p['kernel_encode_Msym_s']:.4f} / B4 zero-copy dec "
              f"{p['kernel_decode_zero_copy_Msym_s']:.4f} Msym/s (host "
              f"wall per call), container {p['container_bytes']} B (equal "
              f"to BENCH_lanes.json), coder and B1 byte-identical, B4 exact",
              flush=True)
    return launches


def chunked_phase(dev):
    """``benchmarks/bench_chunked.run``'s grid (T 2,048, chunks 128 / 512 /
    2,048, lanes 8 / 64 / 256) through ``coder.encode_chunked`` /
    ``decode_chunked`` on the card, one timed call per path: every point's
    ``bits_per_symbol`` and ``flush_overhead_bits`` equal the committed
    ``BENCH_chunked.json`` exactly, and B1 gives the coder's chunks byte
    for byte on each point.  Returns the launches (B1 once a point)."""
    from repro_torch.benchmarks import bench_chunked
    from repro_torch.kernels import LAUNCHES, reset_launches

    ref = {p["name"]: p for p in json.loads(
        (ROOT / "BENCH_chunked.json").read_text())}
    reset_launches()
    pts = bench_chunked.run(device=dev, warmup=False)
    launches = dict(LAUNCHES)
    _check([p["name"] for p in pts] == list(ref), "bench_chunked: points")
    for p in pts:
        r = ref[p["name"]]
        _check(p["bits_per_symbol"] == r["bits_per_symbol"]
               and p["flush_overhead_bits"] == r["flush_overhead_bits"],
               f"{p['name']}: bits {p['bits_per_symbol']} / "
               f"{p['flush_overhead_bits']} against the committed "
               f"{r['bits_per_symbol']} / {r['flush_overhead_bits']}")
        print(f"{p['name']}: {p['bits_per_symbol']!r} bits/symbol, flush "
              f"overhead {p['flush_overhead_bits']!r} (both equal "
              f"BENCH_chunked.json); enc {p['encode_Msym_s']:.4f} / dec "
              f"{p['decode_Msym_s']:.4f} Msym/s (coder, host wall); B1 "
              f"byte-identical", flush=True)
    _check(launches == _only(rans_encode_lanes=len(pts)),
           f"bench_chunked: launch counts {launches}")
    return launches



# ---------------------------------------------------------------------------
# placement (slice 11): chunk and lane meshes over torch.distributed
# ---------------------------------------------------------------------------

PLACE_T = 1024           # four full chunks of 256, no tail
ROW_T = 64               # positions of the 64-against-128-row logit check
SLAB_T = 128             # tokens of the two-slab emulation (256 before
                         # the recurrent placement checks, the slice's 600
                         # before the MoE placement checks; cut for the
                         # time limit)
PLACE_STEPS, PLACE_BATCH, PLACE_SEQ, PLACE_LR = 5, 16, 128, 3e-3


def _nccl_world1(dev):
    """A world-1 NCCL process group over a ``FileStore`` in a temp
    directory (no TCP store); the caller destroys it."""
    import datetime
    import tempfile
    import torch
    import torch.distributed as dist
    store = Path(tempfile.mkdtemp()) / "store"
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(store), 1), rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()),
        timeout=datetime.timedelta(seconds=120))


def _add(total: dict, launches: dict) -> dict:
    return {k: total.get(k, 0) + v for k, v in launches.items()}


def _placed(fn):
    """``fn()`` between a launch-counter reset and read: ``(out,
    launches)``."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(LAUNCHES)


def _chunk_mesh_kernels(dev, mesh):
    """(1) and (2): the chunk mesh's B1 and B3 against the single-device
    kernels and the coder, and the two-rank emulation on one card."""
    import torch
    from repro_torch.core import bitstream, coder, spc
    from repro_torch.core.spc import FreqCdf
    from repro_torch.data.pipeline import token_stream
    from repro_torch.kernels import ops
    from repro_torch.parallel import chunked as pc

    gen = torch.Generator(device=dev).manual_seed(1)
    logits = torch.randn((PLACE_T, LANES, K), generator=gen,
                         device=dev) * 3.0
    tables = spc.tables_from_probs(spc.store_bf16(torch.softmax(logits,
                                                                -1)))
    del logits
    syms = torch.as_tensor(token_stream(K, (LANES, PLACE_T), seed=1),
                           dtype=torch.int32, device=dev)
    tbl = FreqCdf(tables.freq, tables.cdf)
    cands = torch.topk(tables.freq, TOPK, dim=-1).indices.to(torch.int32)
    placed_enc, enc_l = _placed(lambda: pc.encode_chunked(
        syms, tables, CHUNK, mesh=mesh, backend="kernel"))
    _check(enc_l == _only(rans_encode_lanes=1),
           f"placement: placed encode launches {enc_l}")
    single = ops.rans_encode_chunked(syms, tables, CHUNK)
    coded = coder.encode_chunked(syms, tables, CHUNK)
    for a, b, c in zip(placed_enc, single, coded):
        _check(torch.equal(a, b) and torch.equal(a, c),
               "placement: placed encode differs from the single-device "
               "kernel or the coder")
    blob = bitstream.pack_chunked(*placed_enc, chunk_size=CHUNK,
                                  n_symbols=PLACE_T)
    cs = bitstream.parse_chunked(blob)

    def decode_both():
        return [pc.decode_chunked(x, PLACE_T, tbl, CHUNK, mesh=mesh,
                                  backend="kernel", candidates=cands,
                                  lane_probes=True)
                for x in (placed_enc, cs)]

    decoded, dec_l = _placed(decode_both)
    _check(dec_l == _only(rans_decode_lanes=2),
           f"placement: placed decode launches {dec_l}")
    _branch("rans_decode_lanes", {"warp_rows"}, "placed B3")
    sym1, avg1, lp1 = ops.rans_decode_chunked(single, PLACE_T, tbl, CHUNK,
                                              candidates=cands,
                                              lane_probes=True)
    _check(torch.equal(sym1, syms), "placement: single-device decode lost "
           "a symbol")
    for what, (sym, avg, lp) in zip(("dense chunks", "container"), decoded):
        _check(torch.equal(sym, sym1) and torch.equal(lp, lp1)
               and float(avg) == float(avg1),
               f"placement: placed decode from the {what} differs from the "
               "single-device kernel path")
    ms = _median_ms(lambda: pc.encode_chunked(syms, tables, CHUNK,
                                              mesh=mesh, backend="kernel"),
                    repeats=10)
    ms1 = _median_ms(lambda: ops.rans_encode_chunked(syms, tables, CHUNK),
                     repeats=10)
    dms = _median_ms(lambda: pc.decode_chunked(
        placed_enc, PLACE_T, tbl, CHUNK, mesh=mesh, backend="kernel",
        candidates=cands), repeats=10)
    dms1 = _median_ms(lambda: ops.rans_decode_chunked(
        single, PLACE_T, tbl, CHUNK, candidates=cands), repeats=10)
    print(f"placement (1): chunk mesh of {mesh.size} rank ({LANES} lanes x "
          f"{PLACE_T}, chunk {CHUNK}, per-lane K = {K} tables, top-{TOPK}):"
          f" encode byte-identical to ops.rans_encode_chunked and "
          f"coder.encode_chunked, decode from dense chunks and from the "
          f"container equal to the single-device B3 (symbols, per-lane "
          f"probes, avg {float(avg1):.6f}); launches encode {enc_l}, decode "
          f"{dec_l}; per call encode {ms:.4f} ms placed vs {ms1:.4f} ms "
          f"single-device, decode {dms:.4f} vs {dms1:.4f} ms (wrapper "
          "calls, the gather included)", flush=True)
    dense = bitstream.ChunkedLanes(*placed_enc[:3])
    slabs = [pc.encode_slab(syms, tables, CHUNK, r, 2, backend="kernel")
             for r in (0, 1)]
    for a, *parts in zip(placed_enc, *slabs):
        _check(torch.equal(a, torch.cat(parts)), "placement: two-rank "
               "encode emulation differs from the placed encode")
    outs = [pc.decode_slab(dense, PLACE_T, tbl, CHUNK, r, 2,
                           backend="kernel", candidates=cands)
            for r in (0, 1)]
    sym = torch.cat([o[0] for o in outs], 1)
    probes = torch.cat([o[1] for o in outs])
    under = torch.cat([o[2] for o in outs])
    _check(torch.equal(sym, syms) and torch.equal(probes.sum(0), lp1)
           and not bool(under.any()), "placement: two-rank decode "
           "emulation differs from the placed decode")
    print("placement (2): ranks 0 and 1 of a 2-rank chunk mesh run in turn "
          "on the card (encode_slab, decode_slab) and stitched: "
          "byte-identical streams, equal symbols and per-lane probes",
          flush=True)
    return _add(enc_l, dec_l)


def _row_logits(model, tokens, rows: slice, n: int):
    """The teacher-forced logits of ``tokens[rows]``'s first ``n``
    positions (ring length ``SLICE_T``, as the slice prices them)."""
    import torch
    from repro_torch.serve import compress
    vocab = model.cfg.vocab_size
    toks = torch.as_tensor(tokens[rows], dtype=torch.int64,
                           device=next(model.parameters()).device)
    inputs = torch.cat([torch.full_like(toks[:, :1], compress.BOS),
                        toks[:, :n - 1]], 1)
    out = []
    with torch.no_grad():
        compress.teacher_forced_scan(
            model, inputs, SLICE_T,
            lambda lg, t: out.append(lg[:, :vocab].clone()))
    return torch.stack(out)


def _lane_mesh_slice(dev, lane, chunk_mesh, slice_run):
    """(3) and (4): the slice on a lane mesh, two-pass pass 2 on the chunk
    mesh, and the two-slab emulation of a 2-rank lane mesh."""
    import numpy as np
    import torch
    from repro_torch.core import bitstream
    from repro_torch.serve import compress

    model, tokens = slice_run["model"], slice_run["tokens"]
    st, comp_l = _placed(lambda: compress.lm_compress_chunked(
        model, tokens, CHUNK, backend="kernel", mesh=lane))
    blob = bitstream.pack_chunked(*st.chunks, chunk_size=CHUNK,
                                  n_symbols=SLICE_T)
    _check(blob == slice_run["blob"], "placement: the lane-mesh container "
           "differs from the slice's")
    _check(comp_l == _only(rans_encode_lanes=1, spc_quantize=1),
           f"placement: lane-mesh compress launches {comp_l}")
    t0 = time.perf_counter()
    (sym, avg, lp), dec_l = _placed(lambda: compress.lm_decompress_chunked(
        model, slice_run["cs"], SLICE_T, CHUNK, backend="kernel", mesh=lane,
        lane_probes=True))
    t_dec = time.perf_counter() - t0
    _check(dec_l == _only(rans_decode_step=SLICE_T, spc_quantize=SLICE_T),
           f"placement: lane-mesh fused decode launches {dec_l}")
    _check(np.array_equal(sym.cpu().numpy(), tokens)
           and torch.equal(lp, slice_run["lane_probes"]),
           "placement: lane-mesh fused decode differs from the slice's")
    (sym2, avg2), two_l = _placed(lambda: compress.lm_decompress_chunked(
        model, slice_run["cs"], SLICE_T, CHUNK, backend="two_pass",
        mesh=chunk_mesh))
    _check(two_l == _only(rans_decode_lanes=2),
           f"placement: two-pass on the chunk mesh launches {two_l}")
    _check(np.array_equal(sym2.cpu().numpy(), tokens)
           and float(avg2) == float(avg), "placement: two-pass on the chunk "
           "mesh differs from the fused decode")
    print(f"placement (3): {model.cfg.name} at full width, {LANES} x "
          f"{SLICE_T}, chunk {CHUNK}, top-{TOPK}: lm_compress_chunked on a "
          f"lane mesh of {lane.size} rank gives the slice's container byte "
          f"for byte; the fused decode on the lane mesh is bit-exact with "
          f"the slice's per-lane probes ({LANES * SLICE_T / t_dec:.1f} "
          f"symbols/s); two-pass with pass 2 on the chunk mesh gives the "
          f"same symbols and avg probes {float(avg2):.6f}; launches compress "
          f"{comp_l}, fused {dec_l}, two-pass {two_l}", flush=True)
    # (4) two ranks of a 2-rank lane mesh, in turn, over the stream's
    # first SLAB_T tokens, against the whole batch's container of them
    half = LANES // 2
    toks = tokens[:, :SLAB_T]
    whole = compress.lm_compress_chunked(model, toks, CHUNK,
                                         backend="kernel")
    stitched = []
    for r in (0, 1):
        rows = slice(r * half, (r + 1) * half)
        st_k = compress.lm_compress_chunked(model, toks[rows], CHUNK,
                                            backend="kernel")
        st_c = compress.lm_compress_chunked(model, toks[rows], CHUNK,
                                            backend="coder")
        _check(all(torch.equal(a, b) for a, b in zip(st_k.chunks,
                                                     st_c.chunks)),
               f"placement: slab {r}'s kernel and coder containers differ")
        got, _ = compress.lm_decompress_chunked(
            model, st_k.chunks, SLAB_T, CHUNK, backend="kernel")
        _check(np.array_equal(got.cpu().numpy(), toks[rows]),
               f"placement: slab {r} does not round-trip")
        stitched.append(st_k.chunks)
    same = all(torch.equal(torch.cat([a, b], 1), c) for a, b, c in
               zip(*stitched, whole.chunks))
    full = _row_logits(model, tokens, slice(0, LANES), ROW_T)
    dlogit = max(float((_row_logits(model, tokens,
                                    slice(r * half, (r + 1) * half), ROW_T)
                        - full[:, r * half:(r + 1) * half]).abs().max())
                 for r in (0, 1))
    print(f"placement (4): lanes 0-{half - 1} and {half}-{LANES - 1} of the "
          f"first {SLAB_T} tokens priced and decoded as two ranks would: "
          f"each round-trips bit-exactly and"
          f" its kernel container equals its coder container; ROW "
          f"INVARIANCE on this card: the two slabs' containers stitched "
          f"{'EQUAL' if same else 'DIFFER FROM'} the unplaced container; "
          f"largest |dlogit| of a row at {half} rows against {LANES}, over "
          f"the first {ROW_T} positions: {dlogit:.3e}", flush=True)
    return _add(_add(comp_l, dec_l), two_l), dict(slabs_equal=same,
                                                  dlogit=dlogit)


def _engine_on_mesh(dev, lane, model, served):
    """(5): ``bench_serve``'s point through ``BatchEngine(mesh=lane)``."""
    from repro_torch.serve.engine import BatchEngine
    p = SERVE_POINT

    def run():
        eng = BatchEngine(model, slots=p["slots"], lanes=p["lanes"],
                          chunk_size=p["chunk"], max_len=p["n_symbols"],
                          step_backend="kernel", mesh=lane)
        _check(eng.mesh is lane, "placement: the engine did not place its "
               "slots")
        rids = [eng.submit_compress(t, arrival=float(a))
                for t, a in zip(served["data"], served["arrivals"])]
        return rids, eng.run(clock="wall")

    (rids, res), launches = _placed(run)
    for rid, blob in zip(rids, served["blobs"]):
        _check(res[rid].ok and res[rid].blob == blob,
               f"placement: engine request {rid} on the lane mesh differs")
    print(f"placement (5): bench_serve's point ({len(rids)} streams) through "
          f"BatchEngine(mesh=lane_mesh()) under the wall clock: every blob "
          f"equals the unplaced engine's; launches {launches}", flush=True)
    return launches


def _crosspod(dev, pod, cpu_pod):
    """(6) and (7): the cross-pod train step, its residuals, the card's
    reduce against the CPU's, and ``remesh`` through a checkpoint."""
    import copy
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs.ras_pimc import CONFIG
    from repro_torch.data.pipeline import train_batch
    from repro_torch.models import init_model
    from repro_torch.parallel import collectives as col
    from repro_torch.train import checkpoint, fault_tolerance, train_loop

    cfg = CONFIG.with_(grad_accum=1)
    model = init_model(cfg, seed=1, device=dev)
    state = train_loop.init_train_state(model, with_error=True)
    state = state._replace(step=torch.full_like(state.step, 100))
    step = train_loop.make_train_step(cfg, base_lr=PLACE_LR,
                                      compress_crosspod=True, mesh=pod)
    groups = train_loop.crosspod_groups(model)
    n_scales, n_leaves = _scale_count(model, groups)
    losses, residual_ok, flips = [], True, None
    for i in range(PLACE_STEPS):
        batch = train_batch(cfg, PLACE_BATCH, PLACE_SEQ, step=i)
        _, grads = train_loop.grads_fn(copy.deepcopy(state.model), batch)
        e0 = {k: v.clone() for k, v in state.error.items()}
        state, m = step(state, batch)
        xs = {k: g.to(torch.float32) + e0[k] for k, g in grads.items()}
        amax = _group_amax(groups, xs)
        for k, x in xs.items():
            q, s = col.quantize_int8(x, amax[k])
            residual_ok &= bool(torch.equal(
                state.error[k], x - col.dequantize_int8(q, s)))
        if i == 0:
            card, _ = col.compressed_psum_tree(grads, pod, e0, groups=groups)
            host, _ = col.compressed_psum_tree(
                {k: g.cpu() for k, g in grads.items()}, cpu_pod,
                {k: e.cpu() for k, e in e0.items()}, groups=groups)
            flips = sum(int((card[k].cpu() != host[k]).sum()) for k in card)
        losses.append(float(m["loss"]))
    _check(n_scales == n_leaves, f"placement: {n_scales} int8 scales for "
           f"{n_leaves} reference leaves")
    _check(residual_ok, "placement: a residual is not x + e - "
           "dequant(quant(x + e)) with its group's scale")
    _check(flips == 0, f"placement: the card's int8 reduce differs from "
           f"the CPU's in {flips} entries")
    _check(np.isfinite(losses).all() and losses[-1] < losses[0],
           f"placement: the cross-pod loss did not fall {losses}")
    print(f"placement (6): {cfg.name} at full width, {PLACE_STEPS} cross-pod "
          f"steps of {PLACE_BATCH} x {PLACE_SEQ} (lr {PLACE_LR}, from step "
          f"100) over a pod mesh of {pod.size} rank, {n_scales} int8 scales "
          f"a step (one per reference leaf, {n_leaves}; "
          f"{len(groups)} parameters): every residual equals "
          f"x + e - dequant(quant(x + e)) with its group's scale bitwise, "
          f"the card's reduce equals the CPU's bitwise ({flips} flipped "
          f"codes), losses {', '.join(f'{x:.4f}' for x in losses)}",
          flush=True)
    snap = {k: v.copy() for k, v in checkpoint._flatten(
        checkpoint._reference_tree(state))}
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, PLACE_STEPS, state)
        for placement in ("cpu", pod):
            state = fault_tolerance.remesh(state, d, PLACE_STEPS, placement)
            got = dict(checkpoint._flatten(checkpoint._reference_tree(state)))
            _check(set(got) == set(snap) and all(
                got[k].tobytes() == snap[k].tobytes() for k in snap),
                f"placement: remesh onto {placement} is not bitwise")
    _check(next(state.model.parameters()).device == pod.device,
           "placement: remesh did not return to the card")
    print(f"placement (7): the state with its error tree "
          f"({sum(k.startswith('error') for k in snap)} error leaves) "
          "checkpointed, remeshed onto the CPU and back onto the card: "
          "bitwise", flush=True)


def placement_phase(dev, slice_run, served):
    """Slice 11: the chunk and lane meshes, ``mesh=`` through compress,
    decompress and the engine, the cross-pod int8 reduce and ``remesh``,
    on a world-1 NCCL group started over a ``FileStore`` and destroyed at
    the end.  Returns the placed calls' launches (each counted from 0
    just before its call, the comparisons' launches left out) and the
    row-invariance finding."""
    import torch
    import torch.distributed as dist
    from repro_torch.parallel import chunked as pc
    from repro_torch.parallel import collectives as col

    _nccl_world1(dev)
    try:
        chunk, lane = pc.chunk_mesh(device=dev), pc.lane_mesh(device=dev)
        pod = col.pod_mesh(device=dev)
        cpu_pod = col.pod_mesh(dist.new_group(backend="gloo"), device="cpu")
        launches = _chunk_mesh_kernels(dev, chunk)
        torch.cuda.empty_cache()
        more, finding = _lane_mesh_slice(dev, lane, chunk, slice_run)
        launches = _add(launches, more)
        launches = _add(launches, _engine_on_mesh(dev, lane,
                                                  slice_run["model"], served))
        _crosspod(dev, pod, cpu_pod)
    finally:
        dist.destroy_process_group()
    print(f"placement: launches of the placed calls {launches}", flush=True)
    return launches, finding


# --- a placed model with rows over data (slice 19) ---------------------------

# the placed mamba2 engine: slots x lanes x tokens, chunk (the mamba2
# slice's depth and prob_bits); the placed cross-pod step: the trainer's
# 16 x 128 batch (PLACE_BATCH x PLACE_SEQ), XP_STEPS steps from step 100,
# the first XP_WARM of them untimed
PE_M2_SLOTS, PE_M2_LANES, PE_M2_T, PE_M2_CHUNK = 2, 16, 64, 32
XP_STEPS, XP_WARM = 6, 2


def _placed_engine(model, toks, want: list, *, slots: int, lanes: int,
                   chunk: int, max_len: int, bits: int, what: str):
    """``model`` (placed) served by ``BatchEngine`` (the kernel step
    backend): ``toks`` compressed, each blob byte-identical to ``want``'s
    (the unplaced engine's), then the first two blobs decompressed side
    by side, tokens exact; the launches of both runs counted from 0; then
    each request through the placed single-request
    ``lm_compress_chunked``, byte-identical.  Returns ``(launches,
    compress s, decompress s)``."""
    import numpy as np
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve import compress
    from repro_torch.serve.engine import BatchEngine

    def engine():
        return BatchEngine(model, slots=slots, lanes=lanes, chunk_size=chunk,
                           max_len=max_len, prob_bits=bits, topk=TOPK,
                           step_backend="kernel")

    reset_launches()
    t0 = time.perf_counter()
    eng = engine()
    rids = [eng.submit_compress(t) for t in toks]
    res = eng.run()
    t_comp = time.perf_counter() - t0
    got = [res[r].blob for r in rids]
    t0 = time.perf_counter()
    eng = engine()
    dec = [eng.submit_decompress(b) for b in got[:2]]
    res = eng.run()
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    for i, b in enumerate(got):
        _check(b == want[i], f"{what}: engine blob {i} differs from the "
               "unplaced engine's")
    for i, (r, t) in enumerate(zip(dec, toks)):
        _check(res[r].ok and np.array_equal(res[r].tokens, t),
               f"{what}: engine decompress {i} not exact")
    for i, t in enumerate(toks):
        single = _pack(compress.lm_compress_chunked(
            model, t, chunk, bits, backend="kernel").chunks, chunk,
            t.shape[1], bits)
        _check(single == got[i], f"{what}: engine blob {i} differs from "
               "the placed lm_compress_chunked's")
    return launches, t_comp, t_dec


def placed_engine_phase(dev, model, blobs):
    """Slice 19: ``BatchEngine`` with a model placed for compute on
    ``make_mesh_for(1)`` (world-1 NCCL): ``ras-pimc`` ``CONFIG`` (the
    slice's model) at the engine phase's point (``ENGINE_SLOTS`` slots x
    ``LANES`` lanes x ``ENGINE_T`` tokens, chunk ``CHUNK``), its blobs
    byte-identical to the unplaced engine's (``blobs``, the engine
    phase's) and to the placed single-request path's, two decompressed
    exactly side by side (B1 once per slot and cycle, B6 once per prefill
    cycle and per decode step, B2 per step); ``mamba2-130m`` ``CONFIG`` cut to ``M2_LAYERS``
    layers (BF16, K = 50,280, prob_bits 16) at ``PE_M2_*`` alike, against
    its unplaced engine here.  Returns the placed runs' launches."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.mamba2_130m import CONFIG as M2
    from repro_torch.core import constants as C
    from repro_torch.data.pipeline import token_stream
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import init_model
    from repro_torch.parallel import sharding
    from repro_torch.serve.engine import BatchEngine

    smi = _smi()
    toks = [token_stream(K, (LANES, ENGINE_T), seed=s)
            for s in range(ENGINE_SLOTS)]
    m2 = init_model(M2.with_(n_layers=M2_LAYERS), seed=0, device=dev)
    m2_toks = [token_stream(m2.cfg.vocab_size, (PE_M2_LANES, PE_M2_T),
                            seed=40 + s) for s in range(PE_M2_SLOTS)]
    eng = BatchEngine(m2, slots=PE_M2_SLOTS, lanes=PE_M2_LANES,
                      chunk_size=PE_M2_CHUNK, max_len=PE_M2_T,
                      prob_bits=M2_BITS, topk=TOPK, step_backend="kernel")
    rids = [eng.submit_compress(t) for t in m2_toks]
    res = eng.run()
    m2_want = [res[r].blob for r in rids]
    _nccl_world1(dev)
    try:
        dm = make_mesh_for(1, device=dev)
        placed = sharding.place_model(model, dm)
        launches, t_comp, t_dec = _placed_engine(
            placed, toks, blobs, slots=ENGINE_SLOTS, lanes=LANES,
            chunk=CHUNK, max_len=ENGINE_MAX_LEN, bits=C.PROB_BITS,
            what="placed engine")
        n_cyc = -(-ENGINE_T // CHUNK)
        want = _only(rans_encode_lanes=ENGINE_SLOTS * n_cyc,
                     rans_decode_step=ENGINE_T,
                     spc_quantize=n_cyc + ENGINE_T)
        _check(launches == want, f"placed engine: launches {launches}, "
               f"expected {want}")
        syms = LANES * ENGINE_T
        print(f"placed engine: {model.cfg.name} placed on the 1x1 mesh, "
              f"{ENGINE_SLOTS} slots x {LANES} lanes x {ENGINE_T} tokens, "
              f"chunk {CHUNK}: every blob byte-identical to the unplaced "
              "engine's and to the placed lm_compress_chunked's, two "
              "decompressed exactly side by side; launches "
              f"{launches}; compress {ENGINE_SLOTS * syms / t_comp:.1f} "
              f"symbols/s ({t_comp:.3f} s), decompress "
              f"{2 * syms / t_dec:.1f} symbols/s ({t_dec:.3f} s) ({smi})",
              flush=True)
        del placed
        placed = sharding.place_model(m2, dm)
        more, t_comp, t_dec = _placed_engine(
            placed, m2_toks, m2_want, slots=PE_M2_SLOTS, lanes=PE_M2_LANES,
            chunk=PE_M2_CHUNK, max_len=PE_M2_T, bits=M2_BITS,
            what="placed engine, mamba2")
        n_cyc = -(-PE_M2_T // PE_M2_CHUNK)
        want = _only(rans_encode_lanes=PE_M2_SLOTS * n_cyc,
                     rans_decode_step=PE_M2_T,
                     spc_quantize=n_cyc + PE_M2_T)
        _check(more == want, f"placed engine, mamba2: launches {more}, "
               f"expected {want}")
        syms = PE_M2_LANES * PE_M2_T
        print(f"placed engine: {m2.cfg.name} ({m2.cfg.n_layers} layers, "
              f"{m2.cfg.dtype}, vocab {m2.cfg.vocab_size}, prob_bits "
              f"{M2_BITS}) placed on the 1x1 mesh, {PE_M2_SLOTS} slots x "
              f"{PE_M2_LANES} lanes x {PE_M2_T} tokens, chunk "
              f"{PE_M2_CHUNK}: every blob byte-identical to its unplaced "
              "engine's and to the placed lm_compress_chunked's, "
              f"decompressed exactly; launches {more}; compress "
              f"{PE_M2_SLOTS * syms / t_comp:.1f} symbols/s, decompress "
              f"{2 * syms / t_dec:.1f} symbols/s", flush=True)
        del placed, m2
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return _add(launches, more)


def _group_amax(groups: dict, xs: dict) -> dict:
    """Each name of ``xs`` -> the largest ``|x|`` of its group
    (``train_loop.crosspod_groups``): the amax the cross-pod reduce
    quantizes it with."""
    import torch
    maxima: dict = {}
    for k, x in xs.items():
        maxima.setdefault(groups[k], []).append(x.float().abs().max())
    amax = {g: torch.stack(m).max() for g, m in maxima.items()}
    return {k: amax[groups[k]] for k in xs}


def _scale_count(model, groups: dict) -> tuple[int, int]:
    """The cross-pod reduce's scales a step (its groups) and the leaves
    of the model's reference tree (``convert.to_reference``)."""
    from repro_torch.models.convert import to_reference

    def leaves(tree):
        return sum(leaves(v) if isinstance(v, dict) else 1
                   for v in tree.values())

    return len(set(groups.values())), leaves(to_reference(model))


def _code_flips(got: dict, want: dict, grads: dict, amax: dict,
                tol: float) -> int:
    """The entries where two one-rank int8 reduces (``q * scale``, by
    leaf, ``scale`` from ``amax``: the leaf's group's largest ``|x|``)
    differ in their code: each must be one code apart where the
    pre-quantization value of ``grads`` (``want``'s) lies within ``tol``
    codes of a rounding boundary.  Returns their count."""
    import torch
    from repro_torch.parallel import collectives as col
    flips = 0
    for k, g in grads.items():
        _, scale = col.quantize_int8(g, amax[k])
        q_got, q_want = (torch.round(t.float() / scale) for t in (got[k],
                                                                  want[k]))
        diff = q_got != q_want
        if bool(diff.any()):
            x = (g.float() / scale)[diff].abs()
            near = ((x - x.floor() - 0.5).abs() <= tol).all()
            _check(bool(((q_got - q_want)[diff].abs() == 1).all()
                        and near), f"placed cross-pod step: {k}'s reduce "
                   "differs from the unplaced one away from a rounding "
                   "boundary")
            flips += int(diff.sum())
    return flips


def crosspod_placed_phase(dev):
    """Slice 19: the cross-pod int8 step under the compute placement on a
    ``(pod 1, data 1, model 1)`` ``DeviceMesh`` (world-1 NCCL), the pod
    ring on its ``pod`` group: ``ras-pimc`` ``CONFIG`` (float32) at the
    trainer's 16 x 128, ``XP_STEPS`` steps from step 100 (a nonzero
    learning rate).  The first step equals its composition bitwise (the
    placed gradients, ``compressed_psum_tree`` in the groups of
    ``train_loop.crosspod_groups``, one whole scale per leaf of the
    reference's tree, the clip over the shards, lr, AdamW; the residuals
    and the loss too); the scales a step are counted against the
    reference tree's leaves.  Against the unplaced cross-pod step on the
    same pod mesh (whose int8 quantization runs too): the first step's
    gradients within 1e-5 of each leaf's largest entry, their reduces
    equal but for counted one-code differences at rounding boundaries,
    every step's loss within 1e-5; the parameters' largest difference
    after the last step printed (a code flipped at a boundary moves an
    Adam update by up to the learning rate); step ms of both.  Launches
    no kernel (counted)."""
    import copy
    import statistics as st
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.ras_pimc import CONFIG
    from repro_torch.data.pipeline import train_batch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import init_model
    from repro_torch.parallel import collectives as col, sharding
    from repro_torch.train import optimizer, train_loop

    smi = _smi()
    cfg = CONFIG.with_(grad_accum=1)
    model = init_model(cfg, seed=1, device=dev)
    batches = [train_batch(cfg, PLACE_BATCH, PLACE_SEQ, step=i)
               for i in range(XP_STEPS)]
    _nccl_world1(dev)
    reset_launches()
    try:
        dm = init_device_mesh("cuda", (1, 1, 1),
                              mesh_dim_names=("pod", "data", "model"))
        pod = col.pod_mesh(group=dm.get_group("pod"), device=dev)
        placed, twin = (sharding.place_model(model, dm) for _ in range(2))
        pl = twin.placement

        def start(m):
            s = train_loop.init_train_state(m, with_error=True)
            return s._replace(step=torch.full_like(s.step, 100))

        # the first step's parts, placed (on the twin) and unplaced, in
        # the groups of the reference's leaves
        groups = train_loop.crosspod_groups(twin)
        n_scales, n_leaves = _scale_count(model, groups)
        _check(n_scales == n_leaves, f"placed cross-pod step: {n_scales} "
               f"int8 scales for {n_leaves} reference leaves")
        with train_loop.within_pod(twin):
            loss, grads = train_loop.grads_fn(twin, batches[0])
        red, err = col.compressed_psum_tree(
            grads, pod, col.init_error_tree(grads), shard_max=pl.shard_max,
            groups=groups)
        _, plain_grads = train_loop.grads_fn(copy.deepcopy(model),
                                             batches[0])
        plain_red, _ = col.compressed_psum_tree(
            plain_grads, pod, col.init_error_tree(plain_grads),
            groups=groups)
        payload = sum(g.numel() for g in grads.values())   # int8 bytes
        g_worst = _tp_worst(grads, plain_grads,
                            "placed cross-pod step: gradients")
        flips = _code_flips(red, plain_red, plain_grads,
                            _group_amax(groups, plain_grads),
                            127 * (g_worst + 1e-6))
        clipped, _ = optimizer.clip_by_global_norm(red, 1.0,
                                                   total=pl.sum_squares)
        s0 = start(twin)
        want, _ = optimizer.adamw_update(
            clipped, s0.opt, dict(twin.named_parameters()),
            optimizer.cosine_lr(s0.step, base_lr=PLACE_LR))
        del twin, grads, red, clipped, plain_grads, plain_red
        # the two steps in turns, each first every other step
        runs = {name: dict(model=m, state=start(m), ms=[], losses=[],
                           step=train_loop.make_train_step(
                               cfg, base_lr=PLACE_LR, compress_crosspod=True,
                               mesh=pod, **kw))
                for name, m, kw in (("placed", placed, dict(device_mesh=dm)),
                                    ("plain", copy.deepcopy(model), {}))}
        for i, b in enumerate(batches):
            for name in (("placed", "plain") if i % 2 == 0
                         else ("plain", "placed")):
                r = runs[name]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r["state"], met = r["step"](r["state"], b)
                torch.cuda.synchronize()
                r["ms"].append(1e3 * (time.perf_counter() - t0))
                r["losses"].append(met["loss"])
                if name == "placed" and i == 0:
                    got = dict(placed.named_parameters())
                    _check(all(torch.equal(got[k], want[k]) for k in want)
                           and all(torch.equal(r["state"].error[k], err[k])
                                   for k in err)
                           and bool(met["loss"] == loss),
                           "placed cross-pod step: the first step is not "
                           "its composition bitwise")
        launches = dict(LAUNCHES)
    finally:
        dist.destroy_process_group()
    (p_ms, p_loss, p_par), (u_ms, u_loss, u_par) = (
        (st.median(r["ms"][XP_WARM:]), torch.stack(r["losses"]),
         {k: p.detach() for k, p in r["model"].named_parameters()})
        for r in (runs["placed"], runs["plain"]))
    l_worst = _tp_worst({"l": p_loss}, {"l": u_loss},
                        "placed cross-pod step: losses")
    par = max(float((p_par[k] - u_par[k]).abs().max()
                    / u_par[k].abs().max()) for k in u_par)
    _check(launches == _only(), f"placed cross-pod step: launches "
           f"{launches}")
    print(f"placed cross-pod step: {cfg.name} ({cfg.dtype}) on a (pod 1, "
          f"data 1, model 1) mesh, {XP_STEPS} steps of {PLACE_BATCH} x "
          f"{PLACE_SEQ} from step 100, {n_scales} int8 scales a step (one "
          f"per reference leaf, {n_leaves}; a hop carries {payload} B of "
          f"codes and {4 * n_scales} B of scales): the first equal to its "
          "composition bitwise (placed gradients, the int8 ring with each "
          "group's whole scale, clip, AdamW, residuals, loss); against the "
          f"unplaced cross-pod step: gradients within {g_worst:.3e}, the "
          f"reduce "
          f"equal but for {flips} one-code differences at rounding "
          f"boundaries, losses within {l_worst:.3e} (limit 1e-5), "
          f"parameters after {XP_STEPS} steps within {par:.3e} of each "
          f"leaf's largest entry; losses "
          f"{', '.join(f'{float(x):.4f}' for x in p_loss)}; step "
          f"{p_ms:.3f} ms placed, {u_ms:.3f} ms unplaced (medians of "
          f"{XP_STEPS - XP_WARM}, the two in turns) ({smi})", flush=True)
    return launches


# the production mesh and the dry-run: the ras-pimc trainer's timed steps
# (16 x 128, the tooling trainer's batch) after warm-up steps; B3/B4's and
# B2's K on this script's decode paths, each launched on small tables
DRY_STEPS, DRY_WARM = 20, 3
PLAN_DECODE_KS = (256, 1000, 4096, 5000)
PLAN_STEP_KS = (256, 32064, 32768, 50280)
PLAN_LANES, PLAN_T, PLAN_CHUNK = 8, 32, 16


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@contextlib.contextmanager
def _grad_bytes():
    """The bytes of the gradient tree each train step hands to its global
    clip (the step's own tensors), one entry a step."""
    from repro_torch.train import train_loop
    seen = []
    clip = train_loop.clip_by_global_norm

    def spy(tree, max_norm, **kw):
        seen.append(_nbytes(tree.values()))
        return clip(tree, max_norm, **kw)

    train_loop.clip_by_global_norm = spy
    try:
        yield seen
    finally:
        train_loop.clip_by_global_norm = clip


def _train_record(arch: str, what: str, batch: int, seq: int,
                  overrides: dict, state, grads: list, peak: int) -> dict:
    """A trainer run on the card as a dry-run cell: the arch, the batch
    and the config overrides the dry-run traces, and the card's bytes of
    the parameters, of the last step's gradients and of the AdamW moments,
    with the run's peak memory."""
    return dict(arch=arch, what=what, batch=batch, seq=seq,
                overrides=overrides, param=_nbytes(state.model.parameters()),
                grad=grads[-1], moments=_nbytes(
                    list(state.opt.m.values()) + list(state.opt.v.values())),
                peak=peak)


def _pimc_trainer(dev) -> tuple[dict, float]:
    """``ras-pimc`` ``CONFIG`` trained on the card at the tooling
    trainer's 16 x 128: its cell record and the median step time (s)."""
    import torch
    from repro_torch.configs.ras_pimc import CONFIG
    from repro_torch.data.pipeline import train_batch
    from repro_torch.examples import train_small_lm as ex
    from repro_torch.models import init_model
    from repro_torch.train import train_loop

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = init_model(CONFIG, seed=0, device=dev, draw="device")
    state = train_loop.init_train_state(model)
    step = train_loop.make_train_step(CONFIG, base_lr=ex.LR)
    batches = [train_batch(CONFIG, ex.BATCH, ex.SEQ, step=i)
               for i in range(DRY_WARM + DRY_STEPS)]
    secs = []
    with _grad_bytes() as grads:
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            if i >= DRY_WARM:
                secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    rec = _train_record("ras-pimc", "ras-pimc trainer", ex.BATCH, ex.SEQ,
                        {"grad_accum": CONFIG.grad_accum}, state, grads, peak)
    return rec, statistics.median(secs)


def _plan_case(dev, k: int, bits: int, layout: str, zero: bool, t: int):
    """Tables of K symbols (static, or per-lane rows for ``t`` positions)
    and symbols that avoid the zero frequencies (``zero``: symbols 3 and 4
    of every row, inside the first pass of every search)."""
    import numpy as np
    import torch
    from repro_torch.core import spc

    rng = np.random.default_rng(k + 2 * zero)
    shape = None if layout == "static" else (t, PLAN_LANES)
    probs = rng.dirichlet(np.full(k, 0.5), size=shape).astype(np.float32)
    tt = spc.tables_from_probs(torch.as_tensor(probs, device=dev), bits)
    syms = rng.integers(0, k, (PLAN_LANES, t))
    if zero:
        freq = tt.freq.clone().reshape(-1, k)
        freq[:, k // 2] += freq[:, 3:5].sum(-1)
        freq[:, 3:5] = 0
        tt = spc.build_tables(freq.reshape(tt.freq.shape), bits)
        syms[(syms == 3) | (syms == 4)] += 2
    return tt, torch.as_tensor(syms.astype(np.int32), device=dev)


def _plan_branches(dev) -> int:
    """(d): every B3, B4 and B2 launch at the K this script's decodes run
    reports the code path ``kernels.autotune``'s plan gives it, with and
    without zero frequencies.  Returns the launches checked."""
    import torch
    from repro_torch.core import bitstream, coder, u32
    from repro_torch.core.bitstream import ChunkedLanes
    from repro_torch.kernels import autotune, ops, rans_decode

    n = 0
    for k in PLAN_DECODE_KS:
        for layout in ("static", "lane"):
            for zero in (False, True):
                tt, syms = _plan_case(dev, k, 14, layout, zero, PLAN_T)
                ch = ops.rans_encode_chunked(syms, tt, PLAN_CHUNK)
                cells = ch.buf.shape[0] * PLAN_LANES
                what = f"plan K={k} {layout}{' zero' if zero else ''}"
                rans_decode.rans_decode_lanes(ch.buf, ch.start, tt.freq,
                                              tt.cdf, PLAN_T, PLAN_CHUNK,
                                              prob_bits=14)
                plan = autotune.decode_plan(k, cells, layout, 14)
                _branch("rans_decode_lanes", plan.branches(zero),
                        f"{what}: B3 ({plan.path})")
                cs = bitstream.parse_chunked(bitstream.pack_chunked(
                    *ChunkedLanes(*ch), chunk_size=PLAN_CHUNK,
                    n_symbols=PLAN_T))
                planes, cap = ops.slab_planes(cs, dev)
                rans_decode.rans_decode_slab(
                    *planes, tt.freq, tt.cdf, cap=cap, t_len=PLAN_T,
                    chunk_size=PLAN_CHUNK, prob_bits=14)
                plan = autotune.decode_plan(k, cells, layout, 14,
                                            kernel="rans_decode_slab")
                _branch("rans_decode_slab", plan.branches(zero),
                        f"{what}: B4 ({plan.path})")
                n += 2
    for k in PLAN_STEP_KS:
        bits = 16 if k > 4096 else 14
        for zero in (False, True):
            tt, syms = _plan_case(dev, k, bits, "lane", zero, 1)
            enc = coder.chunk_encoded(ChunkedLanes(*ops.rans_encode_chunked(
                syms, tt, 1)), 0)
            dec = coder.decoder_init(enc)
            rans_decode.rans_decode_step(
                enc.buf.contiguous(), u32.bits(dec.s), dec.ptr.to(
                    torch.int32), tt.freq[0], tt.cdf[0], bits)
            plan = autotune.decode_step_plan(k, PLAN_LANES)
            _branch("rans_decode_step", plan.branches(zero),
                    f"plan K={k}{' zero' if zero else ''}: B2 ({plan.path})")
            n += 1
    torch.cuda.synchronize()
    return n


def mesh_dryrun_phase(dev, cells: list) -> dict:
    """The production mesh and the dry-run, on a world-1 NCCL group:
    (a) ``make_mesh_for(1)`` is a (1, 1) ``DeviceMesh`` and
    ``shard_params``/``unshard`` of the ``ras-pimc`` ``CONFIG`` parameters
    round-trip bitwise on the card; (b) for each trainer run in ``cells``
    (the mamba2 and vlm trainers' records) and the ``ras-pimc`` trainer
    run here, the dry-run of that cell on the (1, 1) mesh gives the card's
    parameter, gradient and moment bytes exactly, its total printed beside
    the run's peak; (c) the ``ras-pimc`` step's traced FLOPs over its
    measured time, as a share of the float32 peak; (d) the launch plan
    against the code paths B2, B3 and B4 report.  The dry-run launches no
    kernel (counted).  Returns the dry-run's launches."""
    import torch
    import torch.distributed as dist
    from repro_torch.analysis.roofline import PEAK_FLOPS
    from repro_torch.configs.ras_pimc import CONFIG
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (make_mesh_for, mesh_shape_for,
                                         mesh_shape_of)
    from repro_torch.models import init_model
    from repro_torch.parallel import sharding

    smi = _smi()
    _nccl_world1(dev)
    try:
        dm = make_mesh_for(1)
        _check(mesh_shape_of(dm) == mesh_shape_for(1)
               and tuple(dm.shape) == (1, 1),
               f"make_mesh_for(1) gave {mesh_shape_of(dm)}")
        model = init_model(CONFIG, seed=0, device=dev, draw="device")
        full = {k: p.detach() for k, p in model.named_parameters()}
        specs = sharding.param_specs(model, mesh_shape_of(dm))
        back = sharding.unshard(sharding.shard_params(full, specs, dm),
                                specs, dm)
        _check(all(torch.equal(back[k], full[k]) for k in full),
               "shard_params/unshard did not round-trip bitwise")
        print(f"mesh: make_mesh_for(1) is a {dict(mesh_shape_of(dm).shape)} "
              f"DeviceMesh on {dm.device_type}; shard_params/unshard of the "
              f"{len(full)} {CONFIG.name} CONFIG parameters round-trip "
              "bitwise on the card", flush=True)
        del model, full, back
    finally:
        dist.destroy_process_group()

    pimc, step_s = _pimc_trainer(dev)
    mesh = mesh_shape_for(1)
    reset_launches()
    recs = []
    for cell in [*cells, pimc]:
        shape = ShapeSpec(f"{cell['batch']}x{cell['seq']}", cell["seq"],
                          cell["batch"], "train")
        rec = dryrun.run_cell(cell["arch"], shape, mesh=mesh,
                              overrides=cell["overrides"], verbose=False)
        _check(rec["status"] == "OK", f"dry-run of the {cell['what']}: "
               f"{rec.get('error')}")
        m = rec["memory"]
        got = (m["param_bytes"], m["grad_bytes"], m["optimizer_bytes"])
        want = (cell["param"], cell["grad"], cell["moments"])
        _check(got == want, f"dry-run of the {cell['what']}: parameter, "
               f"gradient and moment bytes {got}, the card's {want}")
        print(f"dry-run {cell['what']} ({cell['arch']} "
              f"{cell['overrides']}, {cell['batch']} x {cell['seq']}, mesh "
              f"1x1): parameters {got[0]} B, gradients {got[1]} B, moments "
              f"{got[2]} B, each equal to the card's tensors; total "
              f"{m['total_bytes']} B (activations {m['activation_bytes']} "
              f"B saved for backward, {m['recompute_bytes']} B of them a "
              f"checkpointed unit's recompute) against max_memory_allocated "
              f"{cell['peak']} B: ratio {m['total_bytes'] / cell['peak']:.3f}"
              f" ({smi})", flush=True)
        recs.append(rec)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    _check(not any(launches.values()), f"the dry-run launched {launches}")
    flops = recs[-1]["trace"]["flops"]
    share = flops / step_s / PEAK_FLOPS["float32"]
    print(f"dry-run ras-pimc trainer: traced {flops:.6g} FLOP a step "
          f"({pimc['batch']} x {pimc['seq']}), measured step {1e3 * step_s:.3f} ms (median "
          f"of {DRY_STEPS}): {flops / step_s / 1e12:.3f} TFLOP/s, "
          f"{100 * share:.2f}% of the float32 peak "
          f"{PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s ({smi})", flush=True)
    n = _plan_branches(dev)
    print(f"launch plan: {n} B2/B3/B4 launches at K in {PLAN_DECODE_KS} "
          f"(B3/B4) and {PLAN_STEP_KS} (B2), static and per-lane, with and "
          "without zero frequencies, each reporting the plan's code path",
          flush=True)
    return launches


# --- driving the phases: the parent and its workers on the one card ---------

# Every phase in the order one process runs them (``--one-process``): name
# -> (the function, the names of the objects it reads, the names of the
# objects it makes, in the order it returns them).  ``dev`` is the card.
PHASES = {
    "B1 encode": (encode_phase, ("dev",), ("b1", "encoded")),
    "B2 decode step": (decode_phase, ("dev", "encoded"), ("b2",)),
    "B3/B4 chunked decode": (chunked_decode_phase, ("dev", "encoded"),
                             ("b4",)),
    "B5 records": (records_phase, ("dev", "encoded"), ("b5",)),
    "Fig. 4(b)": (fig4b_phase, ("dev",), ("fig4b",)),
    "image": (image_phase, ("dev",), ("b3", "image_launches", "b1_image")),
    "B3/B4 cases": (decode_cases_phase, ("dev",), ("cases",)),
    "reference check": (reference_check, ("dev",), ()),
    "slice": (main_path, ("dev",), ("slice_launches", "slice_run")),
    "two-pass": (two_pass_phase, ("slice_run",), ("two_pass_launches",)),
    "C3 row invariance": (
        lambda dev, run: row_invariance_phase(dev, run["model"]),
        ("dev", "slice_run"), ()),
    "C4 prefill": (lambda dev, run: prefill_phase(dev, run["model"]),
                   ("dev", "slice_run"), ()),
    "bench_serve point": (
        lambda dev, run: bench_serve_phase(dev, run["model"])["served"],
        ("dev", "slice_run"), ("served",)),
    "engine": (lambda dev, run: engine_phase(dev, run["model"])[::2],
               ("dev", "slice_run"), ("engine_launches", "engine_blobs")),
    "placement": (lambda dev, run, served: placement_phase(
        dev, run, served)[0], ("dev", "slice_run", "served"),
        ("placement_launches",)),
    "placed engine": (lambda dev, run, blobs: placed_engine_phase(
        dev, run["model"], blobs), ("dev", "slice_run", "engine_blobs"),
        ("placed_engine_launches",)),
    "Fig. 4(a)": (fig4a_phase, ("dev",), ("fig4a",)),
    "B6 SPC": (spc_phase, ("dev",), ("b6",)),
    "Fig. 4(c)": (fig4c_phase, ("dev",), ("fig4c_launches", "pimc_smoke")),
    "mamba2 slice": (mamba2_phase, ("dev",),
                     ("m2_launches", "m2", "m2_placed")),
    "mixtral slice": (moe_phase, ("dev",), ("mx_launches", "mx",
                                            "mx_placed")),
    "zoo rungs": (zoo_phase, ("dev", "pimc_smoke"), ("zoo_launches",)),
    "mamba2 trainer": (mamba2_train_phase, ("dev",), ("m2_state",
                                                      "m2_cell")),
    "BF16 checkpoint": (bf16_checkpoint_phase, ("dev", "m2_state"), ()),
    "dense zoo": (dense_zoo_phase, ("dev",), ()),
    "tensor parallel": (tensor_parallel_phase, ("dev",), ("tp_launches",)),
    "recurrent placed": (recurrent_placed_phase, ("dev",), ()),
    "audio": (audio_phase, ("dev",), ()),
    "top-k": (topk_phase, ("dev",), ()),
    "lanes sweep": (lanes_phase, ("dev",), ("lanes_launches",)),
    "remat": (remat_phase, ("dev",), ()),
    "phi slice": (phi_phase, ("dev",), ("phi_launches", "phi",
                                        "phi_placed")),
    "vlm": (vlm_phase, ("dev",), ("vlm_cell",)),
    "trainer": (trainer_phase, ("dev",), ("trainer_launches",)),
    "placed cross-pod step": (crosspod_placed_phase, ("dev",),
                              ("crosspod_placed_launches",)),
    "launchers": (launchers_phase, ("dev",), ("launcher_launches",)),
    "examples": (examples_phase, ("dev",), ("example_launches",)),
    "chunked sweep": (chunked_phase, ("dev",), ("chunked_launches",)),
    "production mesh and dry-run": (
        lambda dev, m2_cell, vlm_cell: mesh_dryrun_phase(
            dev, [m2_cell, vlm_cell]),
        ("dev", "m2_cell", "vlm_cell"), ("dryrun_launches",)),
}

# The timed kernel comparisons, which the parent runs alone before any
# worker starts (their CUDA-event medians are PERF.md's kernel times), the
# phases of each worker, in order, and the phase the parent runs after
# the workers, on their records.  The phases whose peaks the card could
# not hold twice share the "heavy" worker, in turn; each phase that
# reads another's object runs in its producer's process, after it (the
# dry-run reads two workers' trainer records).  The mamba2, mixtral and
# phi slices' B2 and B6 timings wait in that worker until every other
# worker is done (``_alone``).
PLAN = {
    "parent": ("B1 encode", "B2 decode step", "B3/B4 chunked decode",
               "B5 records", "Fig. 4(b)", "image", "B3/B4 cases",
               "reference check", "Fig. 4(a)", "B6 SPC"),
    "serve": ("slice", "two-pass", "C3 row invariance", "C4 prefill",
              "bench_serve point", "engine", "placement", "placed engine"),
    # the largest peaks (remat, phi, vlm) last: beside the placement
    # phase's, not the engine's
    "heavy": ("mamba2 slice", "mixtral slice", "dense zoo",
              "tensor parallel", "recurrent placed", "audio", "top-k",
              "lanes sweep", "remat", "phi slice", "vlm"),
    "ladder": ("Fig. 4(c)", "zoo rungs", "mamba2 trainer",
               "BF16 checkpoint", "trainer", "placed cross-pod step",
               "launchers", "examples", "chunked sweep"),
    "after": ("production mesh and dry-run",),
}
WORKERS = ("serve", "heavy", "ladder")
# what the parent's merge and its last phase read: the kernels' records,
# every path's launch counts and the trainers' cells (the rest of a
# phase's objects stay in its process)
RECORDS = ("b1", "b2", "b3", "b4", "b5", "b6", "b1_image", "fig4b", "cases",
           "fig4a", "image_launches", "slice_launches",
           "two_pass_launches", "engine_launches", "placement_launches",
           "placed_engine_launches", "crosspod_placed_launches",
           "fig4c_launches", "m2_launches", "m2", "m2_placed",
           "mx_launches", "mx", "mx_placed", "zoo_launches", "tp_launches",
           "phi_launches", "phi", "phi_placed", "trainer_launches",
           "launcher_launches", "example_launches", "lanes_launches",
           "chunked_launches", "dryrun_launches", "m2_cell", "vlm_cell")

# Each phase's peak of memory reserved on the card (GiB; NVIDIA H100 80GB
# HBM3, 700 W: a worker run's, the heavy worker's with the held timings'
# inputs, or a one-process run's where that is larger).  A worker starts
# a phase when the peaks of the phases running in every worker, each
# plus PEAK_MARGIN_GIB, leave room for its own under CARD_BUDGET_GIB (the
# card's 79.2 GiB less the processes' CUDA contexts); a phase of at most
# SMALL_GIB may pass one that waits.  A phase missing here runs with the
# card's memory to itself.
PEAK_GIB = {
    "slice": 2.53, "two-pass": 0.88, "C3 row invariance": 9.22,
    "C4 prefill": 7.09, "bench_serve point": 0.07, "engine": 6.53,
    "placement": 5.60, "Fig. 4(c)": 1.48, "mamba2 slice": 27.48,
    "mixtral slice": 55.04, "zoo rungs": 0.40, "mamba2 trainer": 11.64,
    "BF16 checkpoint": 2.65, "dense zoo": 8.47, "remat": 61.09,
    "tensor parallel": 48.87, "recurrent placed": 46.40, "top-k": 3.21,
    "phi slice": 67.04, "vlm": 62.77, "audio": 51.06, "trainer": 0.36,
    "launchers": 0.20, "examples": 0.18, "lanes sweep": 3.71,
    "chunked sweep": 0.18, "placed engine": 11.27,
    "placed cross-pod step": 4.44,
}
PEAK_MARGIN_GIB, CARD_BUDGET_GIB, SMALL_GIB = 0.5, 76.0, 4.0


def _budget(phase: str) -> float:
    return PEAK_GIB.get(phase, CARD_BUDGET_GIB) + PEAK_MARGIN_GIB


# the kernel timings a worker of the parent holds until the card is its
# own (``_alone``); None in a process that runs them at once
_DEFERRED: list | None = None


def _alone(fn) -> dict:
    """``fn()``, a dict of timed kernel comparisons.  In a worker of the
    parent the call is held until every other worker is done, and the
    dict returned now is filled then (the worker's last step, with the
    card to itself); elsewhere it runs at once."""
    out: dict = {}
    if _DEFERRED is None:
        out.update(fn())
    else:
        _DEFERRED.append((out, fn))
    return out


def _timed(name: str, fn, *args, t0: float):
    """``fn(*args)`` as one phase: the allocator's cache emptied first,
    then the phase's seconds and its peak of memory reserved on the card
    (``max_memory_reserved``, kept across the resets the phase makes
    itself) printed on standard output and standard error."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    seen = [0]
    reset = torch.cuda.reset_peak_memory_stats

    def keep(*a, **kw):
        seen[0] = max(seen[0], torch.cuda.max_memory_reserved())
        return reset(*a, **kw)

    torch.cuda.reset_peak_memory_stats = keep
    reset()
    t1 = time.perf_counter()
    try:
        out = fn(*args)
    finally:
        torch.cuda.reset_peak_memory_stats = reset
    peak = max(seen[0], torch.cuda.max_memory_reserved()) / 2**30
    line = (f"phase {name}: {time.perf_counter() - t1:.1f} s, peak "
            f"{peak:.2f} GiB ({time.perf_counter() - t0:.1f} s in all)")
    print(line, flush=True)
    print(line, file=sys.stderr, flush=True)
    return out


def _run_phases(names, ctx: dict, t0: float, child: bool = False) -> None:
    """Run the phases ``names`` in order in this process, each reading
    its objects from ``ctx`` and putting what it makes there; an object
    that is not a record is dropped after the last of ``names`` that
    reads it.  In a worker of the parent (``child``) each phase starts
    when the parent gives it the card's memory (``@@phase <name>``, then
    ``go`` on standard input) and gives it back when the phase's memory
    is freed (``@@done``)."""
    import gc
    import torch
    last = {a: i for i, n in enumerate(names) for a in PHASES[n][1]}
    for i, name in enumerate(names):
        fn, reads, makes = PHASES[name]
        if child:
            t1 = time.perf_counter()
            print(f"@@phase {name}", flush=True)
            if sys.stdin.readline().strip() != "go":
                raise RuntimeError(f"the parent did not start {name}")
            print(f"{name}: waited {time.perf_counter() - t1:.1f} s for "
                  "the card's memory", flush=True)
        out = _timed(name, fn, *(ctx[a] for a in reads), t0=t0)
        if len(makes) == 1:
            out = (out,)
        if makes:
            ctx.update(zip(makes, out))
        for a in reads:
            if last[a] == i and a != "dev" and a not in RECORDS:
                del ctx[a]
        if child:
            del out
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            print("@@done", flush=True)


def _run_deferred(t0: float) -> None:
    """The kernel timings held by :func:`_alone`, once the parent has
    given this worker the card."""
    print("@@alone", flush=True)
    if sys.stdin.readline().strip() != "go":
        raise RuntimeError("the parent did not give the card")
    _timed("large-K kernels, alone on the card",
           lambda: [out.update(fn()) for out, fn in _DEFERRED], t0=t0)


def _worker(name: str, child: bool) -> int:
    """Run worker ``name``'s phases (:data:`PLAN`) on the card and hand
    its records to the parent as one JSON line (``child``), or print them
    (a worker run alone, for debugging: ``python3 chip_smoke.py --worker
    <name>``; its held kernel timings then run at once)."""
    global _DEFERRED
    from repro_torch.device import configure_cuda_numerics, resolve_device
    t0 = time.perf_counter()
    configure_cuda_numerics()
    ctx = {"dev": resolve_device(None)}
    if child:
        _DEFERRED = []
    _run_phases(PLAN[name], ctx, t0, child)
    if _DEFERRED:
        _run_deferred(t0)
    records = {k: ctx[k] for k in RECORDS if k in ctx}
    print(("@@records " if child else "") + json.dumps(records), flush=True)
    return 0


class _Workers:
    """The worker processes of the parent on the one card: each runs
    ``python3 chip_smoke.py --worker <name> --child`` (or ``command(name)``);
    their lines are relayed with the worker's name in front.  A worker
    asks before each phase (``@@phase <name>``): the phase starts (``go``
    on its standard input) when its peak (:data:`PEAK_GIB`) fits beside
    the running phases' under :data:`CARD_BUDGET_GIB`, in the order
    asked, a phase of at most :data:`SMALL_GIB` passing one that waits;
    ``@@done`` gives the memory back.  A worker that asks for the card
    alone (``@@alone``) gets it once every other worker is done or asking
    for it too, one at a time."""

    def __init__(self, names, t0: float, command=None, budget=_budget):
        import collections
        import os
        import queue
        import threading
        self.t0, self.events, self.budget = t0, queue.Queue(), budget
        self.procs, self.tails, self.records, self.secs = {}, {}, {}, {}
        env = dict(os.environ, PYTHONUNBUFFERED="1")
        command = command or (lambda name: [
            sys.executable, str(Path(__file__).resolve()), "--worker", name,
            "--child"])
        for name in names:
            proc = subprocess.Popen(
                command(name), stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                bufsize=1, env=env)
            self.procs[name] = (proc, time.perf_counter())
            self.tails[name] = collections.deque(maxlen=40)
            for stream in ("stdout", "stderr"):
                threading.Thread(target=self._relay, daemon=True, args=(
                    name, stream, getattr(proc, stream))).start()

    def _relay(self, name: str, stream: str, pipe) -> None:
        for line in pipe:
            line = line.rstrip("\n")
            if stream == "stdout" and line in ("@@alone", "@@done"):
                self.events.put((line[2:], name, None))
            elif stream == "stdout" and line.startswith("@@phase "):
                self.events.put(("phase", name, line[len("@@phase "):]))
            elif stream == "stdout" and line.startswith("@@records "):
                self.records[name] = json.loads(line[len("@@records "):])
            else:
                self.tails[name].append(f"{stream}: {line}")
                print(f"[{name}] {line}", flush=True,
                      file=sys.stdout if stream == "stdout" else sys.stderr)
        self.events.put(("eof", name, None))

    def _fail(self, name: str, why: str) -> None:
        tail = "\n".join(self.tails[name])
        print(f"chip_smoke: worker {name} {why}; its last lines:\n{tail}",
              file=sys.stderr, flush=True)
        raise SystemExit(1)

    def _go(self, name: str) -> None:
        self.procs[name][0].stdin.write("go\n")
        self.procs[name][0].stdin.flush()

    def run(self) -> dict:
        """Wait for every worker; returns the records by worker.  A worker
        that exits nonzero, dies or sends no record stops the others and
        the script (exit 1), its name and last lines on standard
        error."""
        eofs = dict.fromkeys(self.procs, 0)
        live, running, asked, alone, given = set(self.procs), {}, [], [], None
        try:
            while live:
                kind, name, phase = self.events.get()
                if kind == "phase":
                    asked.append((name, self.budget(phase)))
                elif kind == "done":
                    running.pop(name)
                elif kind == "alone":
                    alone.append(name)
                elif eofs[name] == 0:
                    eofs[name] = 1
                else:
                    proc, start = self.procs[name]
                    rc = proc.wait()
                    self.secs[name] = time.perf_counter() - start
                    live.discard(name)
                    running.pop(name, None)
                    if rc:
                        self._fail(name, f"exited with {rc}")
                    if name not in self.records:
                        self._fail(name, "sent no record")
                    print(f"worker {name}: {self.secs[name]:.1f} s "
                          f"({time.perf_counter() - self.t0:.1f} s in "
                          "all)", flush=True)
                if given not in live and alone and live <= set(alone):
                    given = alone.pop(0)
                    self._go(given)
                used, blocked = sum(running.values()), False
                for req in list(asked):
                    w, gib = req
                    if (not blocked or gib <= SMALL_GIB) and (
                            not running or used + gib <= CARD_BUDGET_GIB):
                        asked.remove(req)
                        running[w] = gib
                        used += gib
                        self._go(w)
                    else:
                        blocked = True
        finally:
            for proc, _ in self.procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return self.records


def _kernel_records(r: dict) -> list:
    """The six kernels' records from every phase's (``r``): their device
    times at each shape, their largest differences from the plain
    versions, and each path's launch counts."""
    b1, b2, b3, b4, b5, b6 = (dict(r[k]) for k in ("b1", "b2", "b3", "b4",
                                                   "b5", "b6"))
    b1.update(r["b1_image"])
    b3_err, b3_fig4b_ms, b3_fig4b_call_ms = r["fig4b"]
    b3_cases_err, b4_cases_err = r["cases"]
    b3["max_abs_err"] = max(b3["max_abs_err"], b3_err, b3_cases_err)
    b4["max_abs_err"] = max(b4["max_abs_err"], b4_cases_err)
    b3.update(b3_fig4b_ms=b3_fig4b_ms, b3_fig4b_call_ms=b3_fig4b_call_ms,
              b3_slice_ms=b4["b3_chunked_ms"],
              b3_slice_call_ms=b4["b3_chunked_call_ms"])
    b5.update(r["fig4a"])
    b1.update(b1_fig4a_ms=b5["b1_fig4a_ms"])
    b3.update(b3_fig4a_ms=b5["b3_fig4a_ms"],
              b3_fig4a_call_ms=b5["b3_fig4a_call_ms"])
    # B6 and B2 at the large-K slices' shapes
    for tag, k in (("mamba2", "m2"), ("moe", "mx"), ("phi", "phi")):
        big = r[k]
        b6.update({f"{tag}_{shape}_{f}": big[shape][f]
                   for shape in ("batch", "position")
                   for f in ("ms", "plain_ms", "bound_ms")})
        b6["max_abs_err"] = max(b6["max_abs_err"], big["batch"]["err"],
                                big["position"]["err"])
        b2.update({f"{tag}_{f}": big["b2"][f]
                   for f in ("ms", "plain_ms", "bound_ms", "bound_by")})
        b2["max_abs_err"] = max(b2["max_abs_err"], big["b2"]["err"])
    # each kernel's launches on the main path that runs it
    for rec, launches in ((b1, "slice"), (b2, "slice"), (b3, "image"),
                          (b4, "two_pass"), (b6, "slice")):
        rec["launches"] = r[f"{launches}_launches"][rec["name"]]
    moe_placed = _add(r["mx_placed"], r["phi_placed"])
    paths = (("engine", "engine"), ("placement", "placement"),
             ("placed_engine", "placed_engine"),
             ("crosspod_placed", "crosspod_placed"),
             ("fig4c", "fig4c"), ("mamba2", "m2"), ("moe", "mx"),
             ("zoo", "zoo"), ("phi", "phi"), ("moe_placed", None),
             ("recurrent_placed", None), ("tensor_parallel", "tp"),
             ("trainer", "trainer"), ("launchers", "launcher"),
             ("examples", "example"), ("lanes", "lanes"),
             ("chunked", "chunked"), ("dryrun", "dryrun"))
    for rec in (b1, b2, b3, b4, b5, b6):
        for field, key in paths:
            launches = (moe_placed if field == "moe_placed"
                        else r["m2_placed"] if field == "recurrent_placed"
                        else r[f"{key}_launches"])
            rec[f"{field}_launches"] = launches[rec["name"]]
    return [b1, b2, b3, b4, b5, b6]


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    if argv[:1] == ["--worker"]:
        return _worker(argv[1], "--child" in argv)
    from repro_torch.device import configure_cuda_numerics, resolve_device
    one = "--one-process" in argv
    t0 = time.perf_counter()
    configure_cuda_numerics()
    ctx = {"dev": resolve_device(None)}
    smi = _smi()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    from repro_torch.kernels import _build
    secs = _build.build_all(verbose=True)
    print(f"build: {secs:.2f} s for {len(list(_build.CSRC.glob('*.cu')))} "
          "sources", flush=True)
    if one:
        _run_phases(tuple(PHASES), ctx, t0)
    else:
        _run_phases(PLAN["parent"], ctx, t0)
        ctx = {k: v for k, v in ctx.items() if k in RECORDS or k == "dev"}
        import gc
        gc.collect()
        torch.cuda.empty_cache()
        for records in _Workers(WORKERS, t0).run().values():
            ctx.update(records)
        _run_phases(PLAN["after"], ctx, t0)
    kernels = _kernel_records(ctx)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s in all",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
