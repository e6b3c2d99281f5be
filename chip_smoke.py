#!/usr/bin/env python3
"""Drive paddle_tpu_torch on one CUDA card: build its kernels, hold each
against its plain PyTorch version, serve full-width ResNet-50 over HTTP
and check the replies, train full-width ResNet-50, the image cells of
benchmark/run.py (alexnet, googlenet, vgg16, smallnet), LeNet-5, the
transformer LM and the LSTM text classifier (padded, float32 and under
bf16 AMP each; and over LoD ids) and the wide_deep cell of
benchmark/run.py (sparse tables, f32 and AMP) and its seq2seq cell
(through its v1 config, f32 and AMP) and check their steps, serve the
paged-KV decoder LM over /generate and check its generations, then
measure.

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is skipped; each logs its
seconds):

1. The card (name, power limit), torch/CUDA/nvcc versions, and the
   kernels' build from ``paddle_tpu_torch/csrc`` with nvcc, one process
   per source, all started together; each kernel's ``ptxas -v`` lines
   (and any ptxas warning), the f32 flash kernels' SASS opcode counts,
   and the bf16 wgmma engine's instances, the wgmma filter gradient's and
   the split-TF32 engine's (the f32 matmul, conv and filter gradient) as
   the card reports them (registers, spills, static and dynamic shared
   memory).
2. Each kernel against its plain version on the card, TF32 off, with
   medians of CUDA-event timings of the kernel, the plain version and
   the one PyTorch call that computes the same function, beside the
   bound: the conv forward at every shape one ResNet-50 forward at
   bucket 32 gives it and at ragged batches (1 and 3); the conv forward,
   backward-input (F.conv2d, conv2d_input) and filter gradient
   (conv2d_weight) at every distinct shape of the ResNet-50 training
   step at batch 256 (13); the BN forward and backward (F.batch_norm,
   native_batch_norm_backward) at every distinct BN shape of that step,
   float32 and bf16, each also bit for bit across two calls, with its
   device-only time and launches a call from a profiled window (2; the
   earlier three-launch design, held to the same plain results, 3, its
   event and device time beside), the wrapper's host microseconds a call
   (``host_us``) and the bytes moved a second of device time over the 3
   (forward) and 5 (backward) passes a call needs (``moved_gb_per_s``);
   matmul and softmax at 3, 32 and 256 rows (torch.matmul,
   torch.softmax), the softmax's route at 256 rows, its wrapper's host
   microseconds a call beside torch.softmax's and its device time with
   the L2 flushed between calls (a FLUSH_BYTES write, left out of the
   sum) beside torch.softmax's; the softmax at 2048 rows of each
   SOFTMAX_SWEEP_COLS width (1000 to 262144 columns): the route the rule
   takes (warp, staged over a cluster, two-read), the kernel against its
   plain version, its event and device times beside torch.softmax's, the
   bound and the share of it (``sweep``; the 2048 x 30000 figures also
   as ``wide_*``); the flash-attention forward, dq and dk/dv kernels at
   the transformer step's shape and at ragged ones
   (F.scaled_dot_product_attention and its autograd backward); the
   matmul at the transformer step's five shapes; the matmul at the LSTM
   classifier step's three shapes (B 64, T 100) and the LoD step's two,
   the softmax at their 64 x 2 head; the LSTM forward kernel (hs, cs,
   gates) and backward kernel (LSTMSeq's backward: dxproj, dW, dbias,
   dh0, dc0) at T 100, B 64, H 256, 512 and 1280 and at T 7, B 5, H 100
   (torch.nn.LSTM on cuDNN and autograd of it, timed with the kernels in
   LSTM_ROUNDS alternating rounds; the earlier grid-barrier forward held
   to the same plain result and timed beside, ``grid_ms``; µs a time
   step, the clusters and their blocks, device times from a profiled
   window); the gather at
   the LoD step's ids on the 30000 x 512 table, on a 510-wide table and
   with ids out of range (torch.index_select), its wrapper's host
   microseconds a call and its device time with the L2 flushed, each
   beside index_select's; the conv, matmul, flash forward and LSTM
   wrappers' host microseconds a call at one path shape each (the BN and
   paged wrappers' in their own rows).  For the transformer's
   and the LSTM classifier's AMP steps: the bf16 flash forward, dq
   and dk/dv at the step's shape and at S 200, D 64 and 72 (the plain
   forward walking the kernel's key tiles), the bf16 matmul at the
   transformer's five shapes (torch.matmul in bf16), the bf16 LSTM
   forward and backward at T 100, B 64, H 256 and T 7, B 5, H 100
   (torch.nn.LSTM in bf16 on cuDNN and autograd of it), each within
   BF16_RTOL / BF16_ATOL, bound at 989 TFLOP/s bf16 (the LSTM's f32
   recurrence at 67).  Where the bf16 matmul and conv
   run on the wgmma engine (csrc/wgmma_gemm.cuh: the transformer's
   products, every ResNet-50 conv forward, backward-input and, in
   csrc/conv_dw.cu, filter gradient), the mma.sync tile it replaced is
   held to the same plain result and timed beside it at each shape
   (``mma_sync_ms`` in the kernels line); the
   LSTM classifier's three products are checked in bf16 too, each on
   the engine the rule picks.  Where the f32 matmul and conv run on the
   split-TF32 wgmma engine (csrc/wgmma_tf32.cuh: the transformer's
   products, every ResNet-50 conv forward, backward-input and filter
   gradient, training and serving), the SIMT tile it replaced is held to
   the same plain result and timed beside it (``simt_ms``), the bound as
   split TF32 is 3 x FLOPs at 495 TFLOP/s (``bound_tf32_ms``), and both
   are held to a float64 result: the engine's largest error at most
   GEMM_F64_FACTOR times the SIMT tile's at the transformer's five
   products (at GEMM_F64_ROWS rows), a 3 x 3 conv at C 512 and a 1 x 1 at
   C 2048, forward and backward-input, and the filter gradient of a 3 x 3
   at C 512 on 7 x 7 and of the 1 x 1 at 56 x 56 (64 -> 256); the filter
   gradient's device time is split into its split pass
   (``split_pass_ms``), products and reduce by one profiled call a shape.
   The f32 flash forward (split TF32 too) beside the SIMT forward it
   replaced the same way, its float64 gate (FLASH_F64_FACTOR) at the
   step's shape and at S 200, D 64.  The softmax, gather and paged rows,
   whose event-timed calls are under 0.1 ms, also carry the profiler's
   device-only time of the kernel and of the library call
   (``device_ms``, ``library_device_ms``).
3. Serving: ResNet-50 at full width (3x224x224, 1000 classes) built with
   the port's layers, initialised on the card from a seed, BN running
   statistics overwritten with seeded values, exported with
   save_inference_model and served by InferenceServer(max_batch=32,
   warmup=True) on CUDAPlace(0).  Six concurrent POST /predict requests
   of 1-8 images; every reply must match the same export run by the
   port's Executor on CPUPlace() (the kernels' plain versions): rtol 1e-4,
   atol 1e-5 on the probabilities and the same argmax.  The kernels'
   launch counters, zeroed just before the requests, must read 46 conv,
   1 matmul and 1 softmax launches per forward batch served, every conv
   launch on the split-TF32 wgmma engine.
3b. The serving path's operations on the same export: InferenceServer(
   replicas=2, max_batch=32, warmup=True, tenants=OPS_TENANTS,
   chaos="die@2", dispatch_timeout=OPS_DISPATCH_TIMEOUT), both replicas
   on CUDAPlace(0).  One gold request, then gold and bronze at once (the
   X-Tenant header and the "tenant" key), bronze past its burst; the
   second dispatch dies and its batch is requeued.  Every over-quota
   request gets 429 tenant_over_quota and launches nothing; every
   admitted reply matches the CPU path as in phase 3.  /health says
   degraded (replicas_down:1) while the dead replica is down and ok once
   it is respawned on the card.  Then an injected hang on the surviving
   original replica (OPS_HANG_S past the lease): the lease sweeps it and
   its request is answered once, by another replica.  GET /metrics must
   parse as Prometheus text and agree with what the phase did (deaths by
   cause, restarts, requeued requests, responses by code, forwards in
   serving_batch_size, plan-cache misses of every replica, fetched
   bytes), GET /stats must be the same snapshot, launches 46 conv (all
   on wgmma) + 1 matmul + 1 softmax per forward, device memory after
   both respawns within one replica's parameters of its value before
   the first death, and the Chrome trace must hold serving.predict,
   executor.step and executor.compile.  Logs the telemetry write set's
   cost, Executor.run at bucket 32 with telemetry and with trace_ops
   (one record_function range per op) and the phase's wall time.
4. Throughput of Executor.run at bucket 32 in-process (replayed from
   its CUDA graph), and where one forward's time goes (torch.profiler
   device time by kernel).
4b. ResNet-50 at bucket 32 through a replica eagerly (disable_graphs)
   and through one replaying its CUDA graph: replies equal bit for bit,
   one replay's launches 46 conv (all wgmma), 1 matmul, 1 softmax, and
   Executor.run's median ms of each.
5. Training parity: one step of the ResNet-50 training program
   (mean(cross_entropy(softmax fc)), Momentum(0.1, 0.9), f32, the
   program bench.py builds) at batch 2 on the card against the same step
   on CPUPlace() through the plain versions, from identical weights: the
   loss, every parameter gradient, then every parameter, velocity and BN
   running statistic after the update, each within PARITY_TOL of the
   CPU's largest magnitude (the gradients, velocities and parameters:
   or within FLOOR_FACTOR times the CPU's own spread under a 1e-6
   perturbation of the images where that is larger, since they are
   ill-conditioned at batch 2); then every op of the step on the card
   against the same op on the CPU on identical inputs, within OP_TOL.
6. The training step at batch 256 on the card: the counters, zeroed just
   before the first step and read just after, must show the launches
   the program implies (conv forward 46, backward-input 46, filter
   gradient 46, BN forward 53, BN backward 53, matmul 1, softmax 1; the
   46 + 46 + 46 conv forward, backward-input and filter-gradient launches
   on the split-TF32 wgmma engine, the fc on the SIMT tile);
   then images/s over 5 timed steps after 2 warm-up steps, the peak of
   torch.cuda.max_memory_allocated(), and one profiled step (device idle
   share, top kernels, layout copies; it must see the 46
   wgmma_tf32_dw_kernel launches).
6a. (AMP) The bf16 instances against their plain versions (in phase 2):
   conv forward, backward-input and filter gradient at the 13 distinct
   stride-1 conv shapes of the step at batch 256, BN forward and backward
   at its distinct BN shapes, the matmul at the fc's 256 x 2048 x 1000,
   each within BF16_RTOL / BF16_ATOL; the fused conv + BN statistics
   (conv2d_bn_stats_nhwc, no op calls it) at benchmark/
   pallas_convbn_bench.py's two shapes in float32 and bf16, launched on
   the wgmma engines there, beside the old tile (``tile_ms``), the plain
   conv on the same engine and the split-TF32 bound; medians of
   the kernel, the plain version and the library (F.conv2d on
   channels-last input, conv2d_input, conv2d_weight, F.batch_norm and its
   backward, torch.matmul; for the fused conv F.conv2d plus
   torch.var_mean), bound at 989 TFLOP/s bf16.
6b. AMP parity: one AMP step (paddle_tpu_torch.amp on: bf16 conv, mul
   and BN, f32 master weights) of the ResNet-50 program at batch 2 on
   the card against the same step on CPUPlace() from identical weights:
   the loss within AMP_PARITY_TOL of its value, each BN running
   statistic within AMP_PARITY_TOL of max|CPU| or FLOOR_FACTOR times the
   CPU's own bf16 effect on it (its AMP step against its f32 step)
   where that is larger; then every op on identical inputs within
   AMP_OP_TOL.
6c. The AMP step at batch 256: the counters must show the bf16
   instances the program implies (conv forward 46, backward-input 46,
   filter gradient 46, BN forward 53, BN backward 53, matmul 1) and 1
   float32 softmax, no float32 conv, BN or matmul launch, and every bf16
   conv forward, backward-input and filter-gradient launch on the wgmma
   engine (46, 46, 46; the fc's 256 rows on the mma.sync tile); images/s
   over 5 timed steps after 2 warm-up steps beside the f32 step's, peak
   memory, one profiled step (which must see the 46 wgmma filter-gradient
   launches).
6d. The image cells of benchmark/run.py (IMAGE_CELLS: alexnet, googlenet
   and vgg16 at 224 x 224 and 1000 classes, smallnet =
   resnet_cifar10(depth=20) at 32 x 32 and 10; Momentum(0.01, 0.9)).
   Before phase 2, the work guard: each program's forward conv + fc
   GFLOP an image within FLOPS_RTOL of its published cost.  In phase 2,
   every distinct kernel-route conv shape of the four steps at run.py's
   batch (forward, backward-input, filter gradient; f32 and bf16) against
   its plain version on the engine the rules pick (the plain versions
   checked once and timed IMAGE_PLAIN_REPS times), each model's launches
   summed (event time, device time from one profiled window, library,
   bound, and by engine), the fcs' products and the heads' softmax, and
   BN at VGG-16's and smallnet's shapes.  After phase 6c: each model's
   step at batch 2 (dropouts is_test, every other op training) on the
   card against the CPU, f32 and AMP, end to end and op by op (phases 5
   and 6b); training dropout on the card at each dropout's full-batch
   shape, f32 and bf16 (Out = X * Mask and X@GRAD = Out@GRAD * Mask bit
   for bit, the mask's two values, the kept share within
   IMAGE_DROPOUT_SIGMAS sigma of 1 - p, the same mask for the same
   program and step, another for the next step); each cell's step at
   run.py's batch in f32 and under AMP with dropout on: launches equal to
   launches_implied and wgmma launches to wgmma_implied (each engine's
   share logged), images/s over 5 timed steps after 2 warm-up steps,
   peak memory, one profiled step, a finite loss.
7. LeNet-5 with Adam trains on the card to accuracy > 0.9 on the seeded
   synthetic digits of tests/test_book_convergence.py, in float32 and
   under AMP.
8. Transformer parity: the transformer LM of
   benchmark/transformer_bench.py at full width (d_model 2048, 16 heads,
   4 layers, vocab 32768; Adam(1e-4), f32) for one step at B 1, S 128 on
   the card against CPUPlace(): the loss, every gradient, every
   parameter and Adam moment after the update within TF_PARITY_TOL of
   the CPU's largest magnitude; then every op on identical inputs; then
   the step at B 1, S TF_ENGINE_SEQ (1,024 rows: the products on the
   split-TF32 wgmma engine), every mul op on identical inputs against the
   CPU within OP_TOL, its 17 launches all on the engine.
9. The transformer step at B 8, S 1024: the launches (flash forward 4,
   dq 4, dk/dv 4, all three split-TF32 kernels; matmul 17 all on the
   split-TF32 wgmma engine, softmax 0, the program's own count),
   tokens/s over 5 timed steps after 2 warm-up steps, peak memory (its
   profiled step comes after phase 10b's).
10. A small transformer (d_model 256, 2 layers, vocab 64, S 128) learns
    a seeded copy-the-previous-token task on the card: the loss falls
    below CONVERGE_LOSS.
10a. Transformer AMP parity: the step of phase 8 under AMP (bf16 mul,
    flash attention and lm_head logits; f32 masters and moments), card
    against CPUPlace() from identical weights (amp_step_parity): the
    loss within AMP_PARITY_TOL of its value, every gradient and state
    tensor within AMP_PARITY_TOL of max|CPU| or FLOOR_FACTOR times the
    CPU's own bf16 effect on it; every op on identical inputs within
    AMP_OP_TOL.
10b. The transformer AMP step at B 8, S 1024: launches bf16 flash
    forward 4, dq 4, dk/dv 4, bf16 matmul 17, all 17 on the wgmma
    engine, and no f32 flash or matmul launch; tokens/s beside phase 9's
    f32 step, peak memory; then one
    profiled step of each, f32 and AMP, in a fresh process
    (PROFILE_TF), the device time split into the flash kernels, the
    matmul kernel, the mul backward products and the rest, failing if
    the profiler saw fewer flash or matmul launches than the step makes.
    10c. The small model of phase 10 learns under AMP.
10d. The rest of the Executor on the transformer step at B 8, S 1024
    built with recompute=True (each block and the LM head one
    rematerialization segment), FLAGS.check_program on and
    optimize_program=True (phase_executor_graphs): a dangling fetch
    raises ProgramVerificationError before any launch; the OptReport and
    the donation mask; 2 warm-up and 5 timed steps eagerly
    (disable_graphs) and with the plan captured as a CUDA graph on its
    second run, f32 and under AMP, from one state: losses within 1e-6
    relative, the counters equal and 5 x the program's own count (matmul
    34, flash forward 8, dq 4, dk/dv 4: each segment's forward replayed
    in its backward), the donated parameters and Adam moments keeping
    their storage, tokens/s, peak memory, the idle share profiled in a
    fresh process (PROFILE_GRAPHS); one step against the direct program
    (loss and parameters within TF_PARITY_TOL, peak memory of both);
    build_callable's 5 chained calls captured in one torch.cuda.graph,
    the 5th loss within 1e-6 relative of the 5th Executor.run step's.
    Every phase logs the plans captured as graphs, the plans that ran
    eagerly with the first reason of each, and the graphs still held.
11. LSTM classifier parity: lstm_text_classifier as benchmark/run.py
    trains its `lstm` cell (B 64, T 100, vocab 30000 with ids < 10000,
    emb 512, hidden 256, 2 layers, 2 classes, Momentum(0.01, 0.9), f32)
    at full width for one step at B 2 on the card against CPUPlace():
    end to end (SEQ_PARITY_TOL, or the CPU's own spread under a
    perturbation of the embedding table) and op by op on identical
    inputs, the LSTM's gates handed to its grad op on both sides.
12. The LSTM classifier step at B 64, T 100: launches (lstm 2, lstm
    backward 2, matmul 3, softmax 1, gather 0), samples/s and tokens/s
    over 5 timed steps after 2 warm-up steps, peak memory.
13. A small LSTM classifier (T 20, emb 32, hidden 64, Adam(1e-2)) learns
    whether token 0 occurs: held-out accuracy above SEQ_CONVERGE_ACC.
13a. The LSTM classifier under AMP: parity at B 2 (amp_step_parity);
    the step at B 64, T 100 with launches bf16 lstm 2, bf16 lstm
    backward 2, bf16 matmul 3
    (the engine of each logged: the two 6,400-row projections on wgmma,
    the 64-row head on the mma.sync tile), f32 softmax 1 and no f32 lstm
    (forward or backward) or matmul launch, samples/s beside phase 12's;
    the small classifier
    of phase 13 learns under AMP.
14. LoD classifier parity: LoD ids of 64 sequences with seeded lengths
    in 1-100 -> embedding([30000, 512]) -> fc(256, tanh) ->
    sequence_pool(average) -> fc(2, softmax), Momentum(0.01, 0.9): card
    vs CPU end to end and op by op.
15. The LoD classifier step: launches (gather 1, matmul 2, softmax 1,
    lstm 0), steps/s and rows/s, peak memory.
15a. wide_deep parity: models.wide_deep as benchmark/run.py's
    bench_wide_deep trains it (WD_*: B 1024, wide table 100,000 x 1 read
    by 26 ids, deep table 10,000 x 16 read by 26 fields, hidden (256,
    128), is_sparse, mean(log_loss), Adam(1e-3)) at full width for one
    step at B WD_PARITY_BATCH on the card against CPUPlace(), end to end
    and op by op (as phase 11; fetched SparseGrads compared densified on
    the host, op outputs row for row); then one step on the card
    fetching both tables' W@GRAD as tensors: each a float32 SparseGrad
    of B x 26 rows, no SparseGrad densified during the step; and the
    sparse Adam update under torch.cuda.set_sync_debug_mode("error").
15b. The wide_deep step at B 1024, the feed as run.py draws it: launches
    matmul 3, 2 on the split-TF32 wgmma engine, nothing else; examples/s
    and ms a step over WD_TIMED steps after WD_WARMUP warm-up steps, peak
    memory; the table rows no id touched bit for bit unchanged and their
    Adam moments zero.  (In phase 2: the three forward products at B 1024
    against the plain matmul, f32 and bf16, each on its engine.)
15c-15d. The same under AMP (amp_step_parity at B WD_PARITY_BATCH; 3 bf16
    matmul launches, 2 on the wgmma engine, no f32 matmul launch).
15e. seq2seq parity: benchmark/run.py's seq2seq cell (S2S_*: a GRU
    encoder, a recurrent_group decoder with simple_attention and a
    gru_step_layer, VOCAB 30000, EMB = HID = 512, Adam(1e-3)) built
    through its v1 config (seq2seq_config -> parse_config -> Trainer on
    CUDAPlace(0)) at full width, one step at B S2S_PARITY_BATCH, S
    S2S_PARITY_SEQ with ragged lengths on the card against CPUPlace(),
    end to end and op by op (as phase 11; the recurrent op and its
    replaying grad op included), then the step block's five weights'
    gradients (attention score, the two input projections, gru_unit's
    weight and bias) card against CPU within PARITY_TOL of max and not
    zero, with the matmul launches the forward and the replay make.
15f. The seq2seq step at run.py's size (B 64, S 32), run.py's
    BENCH_CHAIN=0 loop: Executor.run of the Trainer's program under
    scope_guard(t.parameters.scope), the feeds on the card; launches
    matmul 194 (2 on the split-TF32 wgmma engine: the encoder's and the
    vocab projection; the step block's 2 x 32 x 3 on the SIMT tile),
    nothing else (its softmax is over (B, S, vocab): torch.softmax, as
    the JAX op runs jax.nn.softmax off its 2-D kernel path); tokens/s and
    ms a step over S2S_TIMED steps after S2S_WARMUP warm-up steps,
    run.py's model TFLOP/s, peak memory; the fixed batch's loss falls.
    (In phase 2: the matmul at the step's five shapes, f32 and bf16, each
    on the engine its rule picks, the N 1 attention score's included, and
    the softmax kernel at the 2048 x 30000 of its probabilities.)
15g-15h. The same under AMP (amp_step_parity; the step block's weights
    within AMP_PARITY_TOL; 194 bf16 matmul launches, 2 on the wgmma
    engine, the rest on the mma.sync tile).
15i. The reference's v1 demos (V1_DEMOS: mnist_v1, quick_start,
    sequence_tagging, traffic_prediction and the seq2seq demo's training
    half, the port's copies in paddle_tpu_torch/demos/ at their own
    widths, batches and synthetic providers) trained on the card through
    the command line a user runs (``paddle_tpu_torch.trainer.main``) at
    the reference tests' pass counts from their configs' CPU-initialised
    weights (``--init_model_path``): the first two costs within
    PARITY_TOL of the same batches on CPUPlace(), the costs to the
    reference test's gate, ``--job=test`` on the last pass directory;
    ``--job=checkgrad`` on traffic_prediction.  Each demo's launches
    (counters zeroed just before it, read just after), ms a step,
    samples/s and peak memory.
15j. The fluid demos on the card through their ``main``: gan and vae
    (DEMO_STEPS steps) and model_zoo (ResNet-20, 10 steps, export,
    reload) to their reference tests' gates; gan's and model_zoo's first
    two steps against CPUPlace() from the same state (vae draws its
    noise in the graph, from each place's generator); model_zoo's
    reloaded probabilities against the same export on CPUPlace(); the
    same figures.  The demos together must launch rows 1, 2, 3, 4 and
    5-6 (the conv forward, backward-input and filter gradient, matmul,
    softmax, BN forward and backward).
15k. (A) LoD control flow: the While-driven dynamic RNN
    (``build_while_rnn``: lod_rank_table, lod_tensor_to_array, a While
    over array_read, shrink_memory, fc([x_t, h]), array_write, increment
    and less_than, array_to_lod_tensor, sequence_pool, an fc(2) softmax
    head) at the LoD cell's widths, its CPU-initialised parameters
    copied to the card: rows, pooled values and head within WHILE_TOL
    of the CPU's; launches gather 1, matmul 2 an iteration + 1, softmax
    1; the condition's host reads (iterations + 1); ms a batch, peak.
15l. (B) The IfElse attention classifier (``build_ifelse_attention``:
    fc over the LoD rows, sequence_softmax, a weighted sequence_pool, an
    IfElse with an fc in each branch, Adam) for ATTN_STEPS steps: the
    first two costs against the CPU's, the costs falling; launches
    gather 1, matmul 4 (1 on wgmma); ms a step, samples/s, peak.
15m. (C) Training BN on NHWC input at NHWC_BN_SHAPE, bit for bit the
    NCHW op's on the permuted input, and on sequence frames SEQ_BN_SHAPE
    with Length against the plain masked version; BN forward and
    backward 1 + 1 each.
15n. (D) The beam_search op over BEAM_STEPS seeded steps at B 16, K 4,
    V 30000 and beam_search_decode, then decoding.beam_search and
    greedy_search over a seeded Markov step: card and CPU token for
    token (near-tied rows counted and left out), scores within
    BEAM_SCORE_TOL.
15o. The fluid book's semantic-role tagger (``build_srl``: db_lstm at
    SRL_CONFIG's widths, 8 LSTM layers, a CRF head, crf_decoding) from
    the CPU's weights at B SRL_PARITY_BATCH: two costs within
    SRL_COST_TOL of the CPU's, the paths equal but at Viterbi near-ties
    (counted), chunk_eval's counts on both equal; then SRL_STEPS Adam
    steps at B SRL_BATCH: launches lstm 8, lstm_bwd 8, matmul as the
    program implies (the wgmma share printed), the cost a token halving;
    ms a step, sentences/s, peak.
15p. understand_sentiment's convolution_net (``build_text_conv``: two
    LoD sequence_conv_pools of 512 filters) at the LoD cell's widths:
    parity at 4 sequences as 15o's, then TEXT_STEPS Adam steps: launches
    gather 1, matmul 6, softmax 1, the costs falling; ms a step,
    samples/s, peak.
15q. Every op of the fluid tail (``op_tail_cases``) on the card against
    the CPU path, outputs and gradients within OP_TAIL_TOL (integers
    exactly), among them warpctc at B 32 T 100 C 96, hsigmoid over 10,000
    classes, conv2d_transpose, conv3d and pool3d at (4, 16, 16, 32, 32);
    the SSD300 head (``build_ssd_head``: 8,732 priors, B 8, 21 classes,
    multiclass_nms with nms_top_k 400 and keep_top_k 200 on equal
    inputs); nce at V 10,000 at its own samples and sampling_id's
    chi-square; each lr schedule over 5 Momentum steps.
16. One profiled step of each sequence path, of the wide_deep step and
    of the seq2seq step in a fresh process (``chip_smoke.py
    --profile-sequence-steps``; the LSTM classifier, wide_deep and
    seq2seq in f32 and under AMP; the SRL tagger and the text conv net in
    another, ``--profile-tail-steps``): idle share, top kernels, and the
    split into the port's kernels (the LSTM forward and backward kernels
    apart), the mul backward products, the rest and the host (for
    seq2seq also the host time inside the recurrent op, its grad op and
    the replay in it, the gru op and its grad op).
17. (A, in phase 2) The paged-attention kernels against their plain
    versions, atol PAGED_ATOL: the decode kernel at the slice's shape
    (S 16, H 16, D 128, page 16, P 128) with seeded ragged lens in 1-2048
    and with every lens 2048, and at S 5, H 2, D 16, page 8; the chunk
    kernel (split over pages, then the merge) at S 16, T 4 and at S 1,
    T 88 over 512 cached rows, beside its first design's device time, and
    at T 1 on the decode step's lens (a line only: the decode step keeps
    its own kernel); the kernel, plain and gather +
    F.scaled_dot_product_attention (two calls) times beside the bound,
    the device times and the wrappers' host us a call.
18. (B, E) The decoder LM of /generate (TinyDecoderLM at the
    transformer's widths, DEC_CONFIG) on the card against the port's CPU
    path from the same weights: a cold prefill of 4 ragged prompts, 8
    teacher-forced decode steps, a verify step, a prefix-hit prefill;
    logits within DEC_PARITY_TOL of max|CPU|, ids equal up to near-ties;
    launches per call: cold prefill flash forward 4, decode step paged 4,
    verify step and prefix-hit prefill chunk 4, nothing else.
19. (C) /generate over HTTP at full width: 32 concurrent requests
    (prompts of 16-1024 tokens, 8 sharing a 512-token prefix, 64 new
    tokens, streamed and not, a beam of 2, one seeded sample) to
    InferenceServer(None, generator=GenerationEngine(model, max_slots=16,
    prefix_cache=True, beam_max=2)): streamed tokens equal the final ids,
    greedy ids equal each request decoded alone up to near-ties, no page
    leaks, a 503 too_long and a 504; tokens/s, time to first token and
    latency p50/p99, the decode step at 16 slots, prefix hits, peak
    memory.  The counters zeroed around the burst show its kernels.
20. (D) Speculative decoding (n-gram draft, k 4) on the same model: ids
    equal the greedy ones up to near-ties; acceptance ratio, tokens/s.
21. (F) One profiled decode step at 16 slots in a fresh process
    (``chip_smoke.py --profile-decode-step``): idle share, top kernels,
    the cost of the logits' copy to the host.
22. The kernels line (for the bf16 matmul, conv forward,
    backward-input and filter gradient also ``launches_wgmma``, its count
    by path and ``mma_sync_ms``; for the f32 matmul, conv forward,
    backward-input and filter gradient ``launches_wgmma``, its count by
    path, ``simt_ms`` and ``bound_tf32_ms``, the filter gradient's
    ``split_pass_ms``; for the f32 flash kernels ``simt_ms`` and
    ``bound_tf32_ms``; ``device_ms`` and ``library_device_ms`` where phase
    2 took them; for the LSTM rows ``us_per_step``, ``clusters``,
    ``cluster_blocks``, ``resident``, the forward's ``grid_ms`` and
    ``grid_device_ms`` (the earlier design), the backward's ``kernel_ms``
    (its launch alone: its ``ms`` is the whole backward, kernel, dW
    product, dbias and casts); for the conv, matmul, softmax and BN rows
    ``by_model``: the image cells' launches at run.py's batch from phase
    2; ``launches_by_path`` has each demo's as ``demo_<name>`` and phases
    15k-15p's as ``while_rnn``, ``ifelse_attention_train_step``,
    ``bn_{nhwc,nchw,sequence}_step``, ``beams``,
    ``srl_train_step`` and ``text_conv_train_step``), the
    card's name and power limit, and the result.
    A row's ``bound_ms`` is the sum of its launches' own bounds, each the
    larger of its operations and its bytes.

The last line is {"ok": true, "device": {"platform": "gpu", ...}}.
"""

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, bf16
# dense on the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# dense TF32 on the tensor cores: a split-TF32 product (the f32 flash
# backward) is three of them, so its least time is 3 x FLOPs over this
PEAK_TF32_FLOPS = 495e12

GEMM_TOL = dict(rtol=1e-4, atol=1e-4)   # f32 sums of <= 4608 terms, reordered
# the filter gradient sums over every pixel of the batch (up to 802,816
# terms): max abs err <= DW_TOL * max|dW|
DW_TOL = 1e-4
# BN: y and dx elementwise; the per-channel vectors relative to their
# largest magnitude (f32 sums over R rows, the kernel's chunk partials
# added in double)
BN_TOL = dict(rtol=1e-4, atol=1e-4)
BN_VEC_TOL = 1e-4
SOFTMAX_ATOL = 1e-6
# the softmax's wide-row sweep (phase 2): 2048 rows of each width
SOFTMAX_SWEEP_ROWS = 2048
SOFTMAX_SWEEP_COLS = (1000, 4096, 30000, 30001, 65536, 262144)
# the cold readings' L2 flush between calls: a write of this many bytes
# (the H100's L2 holds 50 MB)
FLUSH_BYTES = 128 * 2**20
PROBS_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16 kernels against their plain versions: |kernel - plain| <= BF16_RTOL
# * |plain| + BF16_ATOL * max|plain| per bf16 output (both sum in f32 in
# other orders and round once: a sum near a rounding boundary lands one
# bf16 ulp, at most 2^-7 relative, apart; atol for sums that cancel near
# zero).  Their f32 outputs (filter gradient, BN statistics and vectors)
# keep the f32 tolerances: the operands are the same bf16 values.
BF16_RTOL = 1e-2
BF16_ATOL = 1e-3
# the fused conv's mean and variance: max abs err <= STATS_TOL * max|plain|
# (f32 sums over up to 50,176 rows, the kernel's tiles added in double)
STATS_TOL = 1e-4
# the fused conv's shapes (benchmark/pallas_convbn_bench.py:45-49)
STATS_SHAPES = ((256, 14, 14, 256, 256, 3), (256, 7, 7, 512, 512, 3))
# AMP step at batch 2, card vs CPU: the loss within AMP_PARITY_TOL of its
# value; each BN running statistic within AMP_PARITY_TOL of max|CPU| or
# FLOOR_FACTOR times the CPU's own bf16 effect on it (its AMP step against
# its f32 step from the same start) where that is larger: bf16 activations
# that differ by an ulp where a kernel and its plain version round a sum
# near a boundary move the last stage's statistics over 2 x 7 x 7 rows by a
# few percent, as bf16 itself does; each op on identical inputs within
# AMP_OP_TOL of max|CPU| (an
# output rounded once to bf16 from f32 sums of identical inputs may land
# one ulp of its largest element, 2^-8 = 3.9e-3, away; two for the library
# convs, which cuDNN and the CPU each round their own way)
AMP_PARITY_TOL = 1e-2
AMP_OP_TOL = 8e-3
# train-step parity, card vs CPU: max abs err <= PARITY_TOL * max|CPU| per
# tensor (f32 through 53 conv+BN layers forward and back, sums in other
# orders on the two devices)
PARITY_TOL = 2e-3
# ... or FLOOR_FACTOR times the CPU's own spread under a PERTURB relative
# perturbation of the images, for the ill-conditioned tensors (see
# phase_train_parity)
PERTURB = 1e-6
FLOOR_FACTOR = 4.0
# each op of the step on identical inputs: max abs err <= OP_TOL * max|CPU|
# per output (f32 sums of up to 4608 terms, and BN's backward leaves a
# small difference of large terms in the last stage)
OP_TOL = 1e-3
SERVE_BATCH = 32
TRAIN_BATCH = 256
PARITY_BATCH = 2
REQUEST_SIZES = (1, 3, 8, 2, 5, 4)
BN_EPS = 1e-5

# the kernels of the port: (source, the TPU kernel it replaces)
KERNELS = {
    "conv2d_nhwc": ("paddle_tpu_torch/csrc/conv.cu",
                    "paddle_tpu/pallas/conv.py:161"),
    "conv_bwd_input": ("paddle_tpu_torch/csrc/conv.cu",
                       "paddle_tpu/pallas/conv.py:313"),
    "conv_dw": ("paddle_tpu_torch/csrc/conv_dw.cu",
                "paddle_tpu/pallas/conv.py:252"),
    "batch_norm_fwd": ("paddle_tpu_torch/csrc/batch_norm.cu",
                       "paddle_tpu/pallas/batch_norm.py:124"),
    "batch_norm_bwd": ("paddle_tpu_torch/csrc/batch_norm.cu",
                       "paddle_tpu/pallas/batch_norm.py:197"),
    "matmul": ("paddle_tpu_torch/csrc/matmul.cu",
               "paddle_tpu/pallas/matmul.py:92"),
    "softmax": ("paddle_tpu_torch/csrc/softmax.cu",
                "paddle_tpu/pallas/softmax.py:68"),
    "flash_attention_fwd": ("paddle_tpu_torch/csrc/flash_attention.cu",
                            "paddle_tpu/pallas/flash_attention.py:145"),
    "flash_attention_dq": ("paddle_tpu_torch/csrc/flash_attention.cu",
                           "paddle_tpu/pallas/flash_attention.py:293"),
    "flash_attention_dkv": ("paddle_tpu_torch/csrc/flash_attention.cu",
                            "paddle_tpu/pallas/flash_attention.py:313"),
    "lstm": ("paddle_tpu_torch/csrc/lstm.cu", "paddle_tpu/pallas/lstm.py:112"),
    # the backward of the custom_vjp, a reverse lax.scan (no pallas_call)
    "lstm_bwd": ("paddle_tpu_torch/csrc/lstm.cu",
                 "paddle_tpu/pallas/lstm.py:191"),
    "embedding": ("paddle_tpu_torch/csrc/embedding.cu",
                  "paddle_tpu/pallas/embedding.py:47"),
    "paged_attention": ("paddle_tpu_torch/csrc/paged_attention.cu",
                        "paddle_tpu/decode/attention.py:222"),
    "paged_attention_chunk": ("paddle_tpu_torch/csrc/paged_attention.cu",
                              "paddle_tpu/decode/attention.py:382"),
    # the AMP slice's bf16 instances and the fused conv + BN statistics
    "conv2d_nhwc_bf16": ("paddle_tpu_torch/csrc/conv.cu",
                         "paddle_tpu/pallas/conv.py:161"),
    "conv_bwd_input_bf16": ("paddle_tpu_torch/csrc/conv.cu",
                            "paddle_tpu/pallas/conv.py:313"),
    "conv_dw_bf16": ("paddle_tpu_torch/csrc/conv_dw.cu",
                     "paddle_tpu/pallas/conv.py:252"),
    "batch_norm_fwd_bf16": ("paddle_tpu_torch/csrc/batch_norm.cu",
                            "paddle_tpu/pallas/batch_norm.py:124"),
    "batch_norm_bwd_bf16": ("paddle_tpu_torch/csrc/batch_norm.cu",
                            "paddle_tpu/pallas/batch_norm.py:197"),
    "matmul_bf16": ("paddle_tpu_torch/csrc/matmul.cu",
                    "paddle_tpu/pallas/matmul.py:92"),
    "conv2d_bn_stats": ("paddle_tpu_torch/csrc/conv.cu",
                        "paddle_tpu/pallas/conv.py:288"),
    "conv2d_bn_stats_bf16": ("paddle_tpu_torch/csrc/conv.cu",
                             "paddle_tpu/pallas/conv.py:288"),
    # the transformer's and the LSTM classifier's AMP steps
    "flash_attention_fwd_bf16": ("paddle_tpu_torch/csrc/flash_attention.cu",
                                 "paddle_tpu/pallas/flash_attention.py:145"),
    "flash_attention_dq_bf16": ("paddle_tpu_torch/csrc/flash_attention.cu",
                                "paddle_tpu/pallas/flash_attention.py:293"),
    "flash_attention_dkv_bf16": ("paddle_tpu_torch/csrc/flash_attention.cu",
                                 "paddle_tpu/pallas/flash_attention.py:313"),
    "lstm_bf16": ("paddle_tpu_torch/csrc/lstm.cu",
                  "paddle_tpu/pallas/lstm.py:112"),
    "lstm_bwd_bf16": ("paddle_tpu_torch/csrc/lstm.cu",
                      "paddle_tpu/pallas/lstm.py:191"),
}
# the bf16 instance of each kernel an AMP step runs in bf16 (the softmax
# takes the f32 sum of a bf16 product and an f32 bias)
BF16_OF = {name: name + "_bf16" for name in (
    "conv2d_nhwc", "conv_bwd_input", "conv_dw", "batch_norm_fwd",
    "batch_norm_bwd", "matmul", "flash_attention_fwd", "flash_attention_dq",
    "flash_attention_dkv", "lstm", "lstm_bwd")}

# The transformer LM of benchmark/transformer_bench.py:45-60 at its own
# full width (d_model 2048, 16 heads of 128, 4 layers, vocab 32768,
# ffn_mult 4, causal), trained with Adam(1e-4) in float32 (BENCH_AMP=0).
TF_CONFIG = dict(vocab_size=32768, d_model=2048, num_heads=16, num_layers=4,
                 ffn_mult=4)
TF_BATCH, TF_SEQ = 8, 1024
TF_LR = 1e-4
TF_PARITY_BATCH, TF_PARITY_SEQ = 1, 128
# the products' check on the split-TF32 engine (phase 8): B 1 at this S
TF_ENGINE_SEQ = 1024
# flash kernels against their plain versions: out and lse absolute; the
# gradients relative to their largest magnitude (f32 sums over S keys or
# queries and D, through exp, in another order)
FLASH_ATOL = 1e-4
FLASH_GRAD_TOL = 1e-3
# the f32 backward's split-TF32 kernels against a float64 backward: their
# largest error at most this many times the SIMT kernels' on the same
# inputs (the split keeps float32 accuracy)
FLASH_F64_FACTOR = 2.0
# the same gate for the f32 matmul and conv on the split-TF32 wgmma engine
# against the SIMT tile they replaced (phase 2)
GEMM_F64_FACTOR = 2.0
# rows of the transformer's products in that gate (the reduction, K up to
# 8192, is the step's; fewer rows keep the float64 products short)
GEMM_F64_ROWS = 1024
# transformer step, card vs CPU at full width: the loss, max abs err <=
# TF_PARITY_TOL * max|CPU|; the gradients, parameters and Adam moments the
# same, or FLOOR_FACTOR times the CPU's own spread under a TF_PERTURB
# relative perturbation of the token embedding where that is larger (see
# phase_tf_parity)
TF_PARITY_TOL = 2e-3
TF_PERTURB = 1e-4
# the small model's next-token task: the loss must fall below this (it
# starts near ln 64 = 4.16)
CONVERGE_LOSS = 0.3
CONVERGE_STEPS = 300

# The LSTM text classifier of benchmark/run.py's `lstm` cell
# (benchmark/run.py:47-68, the reference's benchmark/paddle/rnn/rnn.py):
# B 64, T 100, vocab 30000 with ids < 10000, emb 512, hidden 256, 2
# layers, 2 classes, Momentum(0.01, 0.9), f32 (BENCH_AMP=0); not cut.
# `lstm_h512` and `lstm_h1280` differ only in the hidden width, which the
# kernel phase covers.
LSTM_BATCH, LSTM_SEQ, LSTM_EMB, LSTM_HIDDEN = 64, 100, 512, 256
LSTM_VOCAB, LSTM_IDS = 30000, 10000
LSTM_WIDTHS = (256, 512, 1280)
LSTM_PARITY_BATCH = 2
# LSTM kernel against its plain version: hs, cs and gates elementwise (f32
# recurrences through sigmoid and tanh, products of H terms in another
# order); LSTMSeq's gradients relative to their largest magnitude
LSTM_TOL = dict(rtol=1e-4, atol=1e-5)
LSTM_GRAD_TOL = 1e-4
LSTM_ROUNDS = 5
# the LoD path: 64 sequences of seeded lengths in 1-100 (about 3.2 k rows)
LOD_SEQS, LOD_MAX_LEN, LOD_FC = 64, 100, 256
# both sequence steps, card vs CPU: max abs err <= SEQ_PARITY_TOL * max|CPU|
# per tensor, or FLOOR_FACTOR times the CPU's own spread under a
# SEQ_PERTURB relative perturbation of the embedding table where larger
SEQ_PARITY_TOL = 2e-3
SEQ_PERTURB = 1e-4
# the small classifier's seeded "does token 0 occur" task: held-out
# accuracy must pass this
SEQ_CONVERGE_ACC = 0.9
# The wide_deep cell of benchmark/run.py (run.py:322-370, bench_wide_deep):
# B 1024, a wide table of 100,000 rows read by 26 hashed ids, a deep
# table of 10,000 rows x 16 read once per field of 26, an MLP of (256,
# 128), both tables sparse (SparseGrad gradients), mean(log_loss),
# Adam(1e-3), under AMP by default and in float32 (BENCH_AMP=0); not cut.
WD_BATCH, WD_WIDE_VOCAB, WD_DEEP_VOCAB = 1024, 100_000, 10_000
WD_FIELDS, WD_WIDE_IDS, WD_EMB, WD_HIDDEN = 26, 26, 16, (256, 128)
WD_LR = 1e-3
# card vs CPU at full width on this batch (SEQ_PARITY_TOL / AMP_PARITY_TOL)
WD_PARITY_BATCH = 8
# examples/s over WD_TIMED steps after WD_WARMUP warm-up steps
WD_WARMUP, WD_TIMED = 3, 5
# The seq2seq cell of benchmark/run.py (run.py:151-319, bench_seq2seq;
# BASELINE.json's acceptance config #3): a GRU encoder over a 3H
# projection of the source embedding, a recurrent_group decoder with
# simple_attention and a gru_step_layer, the vocab softmax fc hoisted out
# of the loop, classification_cost, Adam(1e-3); VOCAB 30000, EMB = HID =
# 512, S 32, B 64, under AMP by default and in float32 (BENCH_AMP=0);
# trained through its v1 config (parse_config -> Trainer -> Executor.run,
# run.py's BENCH_CHAIN=0 loop); not cut.
S2S_VOCAB, S2S_EMB, S2S_HID, S2S_SEQ, S2S_BATCH = 30000, 512, 512, 32, 64
# card vs CPU at full width at this batch and length, ragged lengths
S2S_PARITY_BATCH, S2S_PARITY_SEQ = 4, 8
# tokens/s over S2S_TIMED steps after S2S_WARMUP warm-up steps (run.py's)
S2S_WARMUP, S2S_TIMED = 3, 10
# The reference's v1 demos (paddle_tpu_torch/demos/, copies of demos/ at
# their own widths, batches, seeds and synthetic providers; none cut),
# trained through the paddle_trainer command line
# (paddle_tpu_torch.trainer.main) at the reference tests' pass counts
# (tests/test_v1_api.py:61-76, tests/test_demos.py:29-58), each held to
# its test's gate on the per-batch costs: name -> (passes, gate, what).
V1_DEMOS = {
    "mnist_v1": (2, lambda c: c[0] > 1.5 and np.mean(c[-3:]) < 0.7 * c[0],
                 "first > 1.5, mean of the last 3 < 0.7 x the first"),
    "quick_start": (6, lambda c: np.mean(c[-3:]) < 0.45,
                    "mean of the last 3 < 0.45"),
    "sequence_tagging": (3, lambda c: np.mean(c[-3:]) < 0.5 * c[0],
                         "mean of the last 3 < 0.5 x the first"),
    "traffic_prediction": (4, lambda c: np.mean(c[-3:]) < 0.3 * c[0],
                           "mean of the last 3 < 0.3 x the first"),
    "seq2seq": (30, lambda c: np.mean(c[-3:]) < 0.25 * c[0],
                "mean of the last 3 < 0.25 x the first"),
}
# the fluid demos' steps (tests/test_demos.py:11-53): gan and vae 300
DEMO_STEPS = 300
# The LoD control flow at the LoD LSTM cell's widths (64 sequences of
# seeded lengths in 1-100, vocab 30000, emb 512, hidden 256; not cut).
# A (the While-driven dynamic RNN): the rows, pooled values and head on
# the card within WHILE_TOL of max|CPU| (f32 products of 768 terms a step
# through 100 tanh steps, summed in another order; TF32 off).  B (the
# IfElse attention classifier): ATTN_STEPS Adam(ATTN_LR) steps over
# ATTN_BATCHES seeded batches in turn, the first two costs within
# ATTN_COST_TOL of the CPU's (relative).
WHILE_TOL = 1e-4
ATTN_STEPS, ATTN_BATCHES, ATTN_LR, ATTN_COST_TOL = 20, 4, 1e-3, 1e-4
# C: training BN on NHWC input at ResNet-50's first stage and on sequence
# frames at the LoD cell's size (B, T, C) with phase A's lengths
NHWC_BN_SHAPE = (256, 56, 56, 64)
SEQ_BN_SHAPE = (LOD_SEQS, LOD_MAX_LEN, LOD_FC)
# D: beam search over BEAM_STEPS steps at B 16, K 4, V 30000; a row whose
# CPU candidates come within BEAM_SCORE_TOL of each other around the
# K-th place (a near-tie the two devices may order either way) is left
# out of the token comparison from that step on, and scores compare
# within BEAM_SCORE_TOL of max(1, max|CPU|)
BEAM_B, BEAM_K, BEAM_V, BEAM_STEPS = 16, 4, LSTM_VOCAB, 32
BEAM_SCORE_TOL = 1e-4
# The fluid op tail.  15o: the fluid book's semantic-role tagger (db_lstm,
# label_semantic_roles) at its widths: six word features sharing one
# 44,068 x 32 table, the predicate's 3,162 x 32 and the mark's 2 x 5
# (CoNLL-05's dictionaries, paddle_tpu/v2/dataset/conll05.py:44-46), fc
# 512 and an LSTM of hidden 128 at each of 8 layers, 67 labels (33 chunk
# types in IOB and O), a CRF head; B 64 sentences of seeded lengths 5-60,
# Adam(1e-3), not cut.  Parity at B 4: the first two costs within
# SRL_COST_TOL (relative) of the CPU path's; the decoded paths equal but
# at Viterbi near-ties (a margin below SRL_TIE), the chunk counts equal.
# Learning: SRL_STEPS steps, the mean of the last 3 costs a token at most
# half the first's.
SRL_WORDS = ("word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2")
SRL_CONFIG = dict(depth=8, word_dict=44068, pred_dict=3162, mark_dict=2,
                  word_dim=32, mark_dim=5, hidden=512, labels=67)
SRL_BATCH, SRL_PARITY_BATCH, SRL_LENS, SRL_LR = 64, 4, (5, 60), 1e-3
SRL_STEPS, SRL_COST_TOL, SRL_TIE = 30, 2e-3, 1e-4
# 15p: understand_sentiment's convolution_net over the LoD cell's ids
# (vocab 30000, emb 512, 64 sequences of seeded lengths 1-100): two
# sequence_conv_pools (filter sizes 3 and 4, 512 filters, tanh, sqrt
# pooling), fc(2, softmax), Adam(TEXT_LR); parity at 4 sequences as 15o's
TEXT_FILTERS, TEXT_LR, TEXT_STEPS = 512, 1e-3, 20
# 15q: each new op on the card against the CPU path within OP_TAIL_TOL of
# max|CPU| (f32), integer outputs exactly; SSD300's head at B 8 over 21
# classes (its six maps give 8,732 priors)
OP_TAIL_TOL = 1e-4
SSD_MAPS = ((38, 4), (19, 6), (10, 6), (5, 6), (3, 4), (1, 4))
SSD_MIN = (30, 60, 111, 162, 213, 264)
SSD_MAX = (60, 111, 162, 213, 264, 315)
SSD_RATIOS = ((2,), (2, 3), (2, 3), (2, 3), (2,), (2,))
SSD_B, SSD_CLASSES, SSD_GT = 8, 21, 6
# the argument that makes the script profile the two sequence steps in a
# process of their own (see phase_seq_profile)
PROFILE_SEQ = "--profile-sequence-steps"
# the same for the two transformer steps (see phase_tf_profile)
PROFILE_TF = "--profile-transformer-steps"
# the same for the tagger's and the text conv net's steps (see
# phase_tail_profile)
PROFILE_TAIL = "--profile-tail-steps"
#: The flag of phase 10d's child: the recompute transformer step
#: profiled eagerly and replayed from its CUDA graph, f32 and AMP.
PROFILE_GRAPHS = "--profile-graph-steps"

# The decoder LM that /generate serves (paddle_tpu/decode/model.py
# TinyDecoderLM) at the widths of the transformer LM of phases 8-9
# (benchmark/transformer_bench.py:45-60): vocab 32768, d_model 2048, 16
# heads of 128, 4 layers, max_len 2048; 4096 pages of 16 rows, 128 pages
# a sequence (2048 rows), 16 slots; float32, random weights from a seed.
DEC_CONFIG = dict(vocab=32768, d_model=2048, num_heads=16, num_layers=4,
                  max_len=2048, num_pages=4096, page_size=16,
                  pages_per_seq=128)
DEC_SLOTS = 16
DEC_SEED = 2027
# the paged kernels against their plain versions, absolute (f32 softmax
# sums over up to 2048 positions through exp, in another order)
PAGED_ATOL = 1e-4
# logits, card vs the port's CPU path (and batched vs one at a time):
# max abs err <= DEC_PARITY_TOL * max|reference logits| at every step; a
# generated id may differ only where the reference's top-2 logit gap is
# below DEC_PARITY_TOL * max|logits| there (a near-tie of random weights)
DEC_PARITY_TOL = 1e-3
# phase B: the prompts' lengths, the teacher-forced decode steps
DEC_PARITY_PROMPTS = (37, 300, 600, 1000)
DEC_PARITY_STEPS = 8
# phase C: the burst over HTTP
GEN_REQUESTS, GEN_NEW_TOKENS, GEN_SHARED_PREFIX = 32, 64, 512
# the argument that makes the script profile one decode step in a process
# of its own (see phase_decode_profile)
PROFILE_DEC = "--profile-decode-step"

# The image cells of benchmark/run.py (run.py:41-50 defaults, :55-91 the
# step): model -> (run.py's default batch, image, classes, the published
# forward GFLOP of one image, copied from benchmark/flops.py:84-87), each
# trained with Momentum(0.01, 0.9), under AMP by default (run.py:101-102)
# and in float32 (BENCH_AMP=0); smallnet is resnet_cifar10(depth=20).
IMAGE_CELLS = {
    "alexnet": (128, (3, 224, 224), 1000, 1.43),
    "googlenet": (128, (3, 224, 224), 1000, 3.2),
    "vgg16": (256, (3, 224, 224), 1000, 31.0),
    "smallnet": (256, (3, 32, 32), 10, 0.082),
}
IMAGE_LR, IMAGE_MOMENTUM = 0.01, 0.9
# the work guard: counted forward GFLOP a image within this share of the
# published figure (benchmark/flops.py:90's rtol)
FLOPS_RTOL = 0.35
# the kept share of a dropout mask within this many sigma of 1 - p
IMAGE_DROPOUT_SIGMAS = 4.0
# the plain versions at the image cells' shapes are checked once and
# timed this many times (VGG-16's largest float32 conv is ~1 TFLOP a call)
IMAGE_PLAIN_REPS = 2

# phase 3b: two tenants (name:rate:burst:weight): gold unmetered in
# practice, bronze with a burst of 2 and no refill within the phase
OPS_TENANTS = "gold:1000:64:4,bronze:0.001:2:1"
OPS_BRONZE_BURST = 2
# the burst's requests: gold sizes, and bronze single images (two past
# bronze's burst)
OPS_GOLD_SIZES = (1, 3, 8, 2)
OPS_BRONZE_REQUESTS = 4
# the lease, and an injected hang well past it; the hung request's rows
OPS_DISPATCH_TIMEOUT = 3.0
OPS_HANG_S = 6.0
OPS_HANG_ROWS = 4


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def ptxas_entry(line):
    """``kernel<template args>`` from the mangled name in a ptxas
    "Compiling entry function" line (integer and bool arguments; type
    arguments left out)."""
    mangled = line.split("'")[1] if "'" in line else line
    # <length><identifier>, tried at every digit: a name's own digits may
    # run into the next length (4tf3217wgmma_tf32_kernel)
    for m in re.finditer(r"(?=(\d+))", mangled):
        end = m.start() + len(m.group(1))
        name = mangled[end:end + int(m.group(1))]
        if name.endswith("_kernel") and name.isidentifier():
            rest = mangled[end + len(name):]
            targs = rest[:rest.find("EE") + 1] if rest.startswith("I") else ""
            args = re.findall(r"L[ib](\d+)E", targs)
            return f"{name}<{','.join(args)}>" if args else name
    return mangled


def kernel_name(key):
    """``name_kernel<args>`` out of a profiler's demangled kernel name."""
    m = re.search(r"(\w+_kernel(<[^>]*>)?)", key)
    return m.group(1) if m else key[:60]


def bound(flops, nbytes, peak=PEAK_F32_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def time_ms(fn, reps=10, warmup=2, all_times=False):
    """Median of CUDA-event timings of ``fn`` (each rep timed alone);
    with ``all_times``, (median, every rep's ms)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    if all_times:
        return statistics.median(times), times
    return statistics.median(times)


def cuda_window(body, ok=bool, what="a profiled window", tries=7):
    """The CUDA rows of ``key_averages()`` of one profiled window of
    ``body()`` (CUDA activity only, a synchronise at its end).  The
    profiler on the card sometimes leaves ctypes-launched kernels out of a
    window: one window in 36 missed a BN forward's two launches, and once
    three windows in a row saw no kernel at all.  A window whose rows fail
    ``ok`` (by default: it saw no kernel) is logged and taken again after
    a pause that doubles from 0.25 s, up to ``tries`` windows; the last
    one is returned, and the caller judges it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            body()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")]
        if ok(rows) or attempt == tries - 1:
            return rows
        pause = 0.25 * 2 ** attempt
        log(f"{what}, window {attempt + 1}: the profiler saw "
            f"{sum(e.count for e in rows)} kernel launches in {len(rows)} "
            f"records; taken again after {pause:.2f} s")
        time.sleep(pause)


def device_ms(fn, reps=5):
    """{CUDA kernel name: device ms per call} of ``fn``, from one profiled
    window of ``reps`` calls after one unprofiled call (``cuda_window``):
    the kernels' own time, without the wrapper's host work that
    ``time_ms`` brackets."""
    import torch

    fn()
    torch.cuda.synchronize()

    def body():
        for _ in range(reps):
            fn()

    return {e.key: e.self_device_time_total / 1e3 / reps
            for e in cuda_window(body)}


def cold_device_ms(fn, reps=5):
    """Device ms a call of ``fn`` with the L2 flushed before each call: a
    write of FLUSH_BYTES to a scratch tensor between the calls of one
    profiled window, the flush's own kernels (their names from a profiled
    flush alone) left out of the sum."""
    import torch

    scratch = torch.empty(FLUSH_BYTES // 4, device="cuda")

    def flush():
        scratch.fill_(1.0)

    flush_keys = set(device_ms(flush))
    fn()
    torch.cuda.synchronize()

    def body():
        for _ in range(reps):
            flush()
            fn()

    rows = cuda_window(body, lambda r: any(e.key not in flush_keys
                                            for e in r))
    return sum(e.self_device_time_total for e in rows
               if e.key not in flush_keys) / 1e3 / reps


def counters():
    """The launch counters of every kernel wrapper, by kernel name."""
    from paddle_tpu_torch.kernels import batch_norm as kbn
    from paddle_tpu_torch.kernels import conv as kconv
    from paddle_tpu_torch.kernels import embedding as kemb
    from paddle_tpu_torch.kernels import flash_attention as kfa
    from paddle_tpu_torch.kernels import lstm as klstm
    from paddle_tpu_torch.kernels import matmul as kmatmul
    from paddle_tpu_torch.kernels import paged_attention as kpa
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    return dict(conv2d_nhwc=kconv.launches,
                conv_bwd_input=kconv.bwd_input_launches,
                conv_dw=kconv.dw_launches, batch_norm_fwd=kbn.launches,
                batch_norm_bwd=kbn.bwd_launches, matmul=kmatmul.launches,
                softmax=ksoftmax.launches, flash_attention_fwd=kfa.launches,
                flash_attention_dq=kfa.dq_launches,
                flash_attention_dkv=kfa.dkv_launches, lstm=klstm.launches,
                lstm_bwd=klstm.bwd_launches,
                embedding=kemb.launches, paged_attention=kpa.launches,
                paged_attention_chunk=kpa.chunk_launches,
                conv2d_nhwc_bf16=kconv.launches_bf16,
                conv_bwd_input_bf16=kconv.bwd_input_launches_bf16,
                conv_dw_bf16=kconv.dw_launches_bf16,
                batch_norm_fwd_bf16=kbn.launches_bf16,
                batch_norm_bwd_bf16=kbn.bwd_launches_bf16,
                matmul_bf16=kmatmul.launches_bf16,
                conv2d_bn_stats=kconv.stats_launches,
                conv2d_bn_stats_bf16=kconv.stats_launches_bf16,
                flash_attention_fwd_bf16=kfa.launches_bf16,
                flash_attention_dq_bf16=kfa.dq_launches_bf16,
                flash_attention_dkv_bf16=kfa.dkv_launches_bf16,
                lstm_bf16=klstm.launches_bf16,
                lstm_bwd_bf16=klstm.bwd_launches_bf16)


def wgmma_counters():
    """The launches that ran on a wgmma engine (they count in
    ``counters()`` too): the f32 matmul, conv forward, backward-input,
    filter gradient and fused statistics in split TF32, the bf16 matmul,
    conv forward, backward-input, filter gradient and fused
    statistics."""
    from paddle_tpu_torch.kernels import conv as kconv
    from paddle_tpu_torch.kernels import matmul as kmatmul

    return dict(matmul=kmatmul.launches_wgmma,
                conv2d_nhwc=kconv.launches_wgmma,
                conv_bwd_input=kconv.bwd_input_launches_wgmma,
                conv_dw=kconv.dw_launches_wgmma,
                matmul_bf16=kmatmul.launches_bf16_wgmma,
                conv2d_nhwc_bf16=kconv.launches_bf16_wgmma,
                conv_bwd_input_bf16=kconv.bwd_input_launches_bf16_wgmma,
                conv_dw_bf16=kconv.dw_launches_bf16_wgmma,
                conv2d_bn_stats=kconv.stats_launches_wgmma,
                conv2d_bn_stats_bf16=kconv.stats_launches_bf16_wgmma)


def zero_counters():
    from paddle_tpu_torch.kernels import batch_norm as kbn
    from paddle_tpu_torch.kernels import conv as kconv
    from paddle_tpu_torch.kernels import embedding as kemb
    from paddle_tpu_torch.kernels import flash_attention as kfa
    from paddle_tpu_torch.kernels import lstm as klstm
    from paddle_tpu_torch.kernels import matmul as kmatmul
    from paddle_tpu_torch.kernels import paged_attention as kpa
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    kconv.launches = kconv.bwd_input_launches = kconv.dw_launches = 0
    kconv.launches_bf16 = kconv.bwd_input_launches_bf16 = 0
    kconv.dw_launches_bf16 = 0
    kconv.stats_launches = kconv.stats_launches_bf16 = 0
    kconv.stats_launches_wgmma = kconv.stats_launches_bf16_wgmma = 0
    kconv.launches_bf16_wgmma = kconv.bwd_input_launches_bf16_wgmma = 0
    kconv.dw_launches_bf16_wgmma = kmatmul.launches_bf16_wgmma = 0
    kconv.launches_wgmma = kconv.bwd_input_launches_wgmma = 0
    kconv.dw_launches_wgmma = kmatmul.launches_wgmma = 0
    kbn.launches = kbn.bwd_launches = 0
    kbn.launches_bf16 = kbn.bwd_launches_bf16 = 0
    kmatmul.launches = kmatmul.launches_bf16 = ksoftmax.launches = 0
    kfa.launches = kfa.dq_launches = kfa.dkv_launches = 0
    kfa.launches_bf16 = kfa.dq_launches_bf16 = kfa.dkv_launches_bf16 = 0
    klstm.launches = klstm.launches_bf16 = kemb.launches = 0
    klstm.bwd_launches = klstm.bwd_launches_bf16 = 0
    kpa.launches = kpa.chunk_launches = 0


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_close(name, got, want, **tol):
    import torch

    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, **tol):
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max abs err {err:.3e}, tolerance {tol})")
    return err


def check_scaled(name, got, want, tol):
    """max abs err <= tol * max|want|; returns the max abs err."""
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    if not err <= tol * scale:
        fail(f"{name}: kernel disagrees with its plain version (max abs err "
             f"{err:.3e} > {tol} * max|plain| {scale:.3e})")
    return err


def _conv_kernel_op(op, block, filter_slot="Filter", attrs=None):
    """Whether a conv2d (or conv2d_grad) op runs on the kernels."""
    from paddle_tpu_torch.ops.nn_ops import conv_kernel_applies

    attr = (attrs or op.attrs).get
    w = block.var(op.input(filter_slot)[0]).shape
    return conv_kernel_applies(attr("groups", 1),
                               tuple(attr("dilations", (1, 1))),
                               tuple(attr("strides", (1, 1))),
                               tuple(attr("paddings", (0, 0))), w[2], w[3])


def conv_shapes_of(program, batch):
    """{(n, h, w, c, o, k): count} of the conv kernel's launches in one
    forward of ``program`` at ``batch`` rows, from the shape metadata."""
    block = program.global_block()
    shapes = {}
    for op in block.ops:
        if op.type != "conv2d" or not _conv_kernel_op(op, block):
            continue
        x = block.var(op.input("Input")[0]).shape
        w = block.var(op.input("Filter")[0]).shape
        key = (batch, x[2], x[3], x[1], w[0], w[2])
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def bn_shapes_of(program, batch):
    """{(n, h, w, c): count} of the training batch_norm ops of
    ``program`` at ``batch`` rows."""
    block = program.global_block()
    shapes = {}
    for op in block.ops:
        if op.type == "batch_norm" and not op.attr("is_test", False):
            _, c, h, w = block.var(op.input("X")[0]).shape
            shapes[(batch, h, w, c)] = shapes.get((batch, h, w, c), 0) + 1
    return shapes


def bn_input_is_conv(op, block):
    """Whether a batch_norm (or batch_norm_grad) op's X is a conv2d's
    output: under AMP that is bf16 (ResNet's bias-free convs), while a
    conv followed by its bias add (VGG-16's) gives BN a float32 X."""
    x = (op.attr("__fwd_inputs__")["X"][0] if op.type.endswith("_grad")
         else op.input("X")[0])
    return any(w.type == "conv2d" and x in w.output_arg_names
               for w in block.ops)


def launches_implied(program, amp=False, steps=0):
    """The kernel launches one run of a training ``program`` implies; with
    ``amp``, the conv, matmul, flash attention and LSTM launches are their
    bf16 instances' (under AMP every activation those kernels see is bf16
    or cast to it), and a BN's are where its X is a conv's bf16 output
    (``bn_input_is_conv``; the float32 instance's after a bias add).  A
    ``recurrent`` op runs its step block's kernel ops ``steps`` times,
    and its ``recurrent_grad`` as many again (the replay, through the
    kernels' autograd Functions)."""
    from paddle_tpu_torch.kernels import flash_attention as kfa

    block = program.global_block()
    want = dict.fromkeys(KERNELS, 0)
    f32_bn = dict(batch_norm_fwd=0, batch_norm_bwd=0)
    for op in block.ops:
        if (amp and op.type in ("batch_norm", "batch_norm_grad")
                and not bn_input_is_conv(op, block)):
            f32_bn["batch_norm_fwd" if op.type == "batch_norm"
                   else "batch_norm_bwd"] += 1
            continue
        if op.type == "conv2d" and _conv_kernel_op(op, block):
            want["conv2d_nhwc"] += 1
        elif op.type == "conv2d_grad" and _conv_kernel_op(
                op, block, attrs=op.attr("__fwd_attrs__")):
            want["conv_bwd_input"] += bool(op.output("Input@GRAD")[0])
            want["conv_dw"] += bool(op.output("Filter@GRAD")[0])
        elif op.type == "batch_norm":
            want["batch_norm_fwd"] += 1
        elif op.type == "batch_norm_grad":
            want["batch_norm_bwd"] += 1
        elif op.type == "mul":
            want["matmul"] += 1
        elif op.type == "softmax":
            # the kernel takes a 2-D X, as the JAX op's Pallas kernel
            want["softmax"] += len(block.var(op.input("X")[0]).shape) == 2
        elif op.type in ("scaled_dot_product_attention",
                         "scaled_dot_product_attention_grad"):
            _, s, _, d = block.var(op.input("Q")[0]).shape
            applies = kfa.kernel_applies(s, s, d)
            if op.type.endswith("_grad"):
                want["flash_attention_dq"] += applies
                want["flash_attention_dkv"] += applies
            else:
                want["flash_attention_fwd"] += applies
        elif op.type == "lstm":
            want["lstm"] += lstm_kernel_op(op, block)
        elif op.type == "lstm_grad":
            want["lstm_bwd"] += lstm_kernel_op(
                op, block, op.attr("__fwd_attrs__").get)
        elif op.type == "lookup_table":
            # the gather kernel takes the lookups whose ids are 1-D once
            # their trailing 1 is squeezed: (N, 1) LoD ids
            ids = block.var(op.input("Ids")[0]).shape
            want["embedding"] += len(ids) - (ids[-1] == 1) == 1
        elif op.type == "recompute_segment_grad":
            # the segment's forward replayed under autograd: its kernels
            # launch again through their autograd Functions, and the
            # flash backward's dq and dk/dv kernels run in the pull-back
            for sub_op in op.attr("__seg_ops__"):
                if sub_op.type == "mul":
                    want["matmul"] += 1
                elif sub_op.type == "scaled_dot_product_attention":
                    _, s, _, d = block.var(sub_op.input("Q")[0]).shape
                    applies = kfa.kernel_applies(s, s, d)
                    want["flash_attention_fwd"] += applies
                    want["flash_attention_dq"] += applies
                    want["flash_attention_dkv"] += applies
                elif sub_op.type in ("conv2d", "batch_norm", "lstm",
                                     "softmax", "lookup_table"):
                    fail(f"launches_implied: no rule for a {sub_op.type} "
                         "op in a recompute segment")
        elif op.type in ("recurrent", "recurrent_grad"):
            attrs = (op.attr("__fwd_attrs__") if op.type.endswith("_grad")
                     else op.attrs)
            for sub_op in attrs["sub_block"].ops:
                if sub_op.type == "mul":
                    want["matmul"] += steps
                elif sub_op.type in ("conv2d", "batch_norm", "lstm",
                                     "softmax",
                                     "lookup_table",
                                     "scaled_dot_product_attention"):
                    fail(f"launches_implied: no rule for a {sub_op.type} "
                         "op in a step block")
    if amp:
        for name, bf16 in BF16_OF.items():
            want[bf16], want[name] = want[name], 0
        want.update(f32_bn)
    return want


def lstm_kernel_op(op, block, attr=None):
    """Whether an lstm op (an lstm_grad op, with its forward's ``attr``)
    runs the LSTM kernels (default activations, no peepholes)."""
    from paddle_tpu_torch.ops.sequence_ops import _kernel_path

    bias = op.input("Bias")
    bias_var = block.var(bias[0]) if bias and bias[0] else None
    h = block.var(op.input("Weight")[0]).shape[0]
    return _kernel_path(attr or op.attr, bias_var, h)


class _Sum:
    """A kernel's times, bound and error summed over one run's launches.
    The bound is the sum of each launch's own bound (the larger of its
    operations and its bytes), not the bound of the summed operations and
    bytes, which understates a row whose launches are bound by different
    things; ``bound_by`` names what bounds the larger share of it."""

    def __init__(self, peak=PEAK_F32_FLOPS):
        self.peak = peak
        self.ms = self.plain_ms = self.library_ms = 0.0
        self.bound_ms = {"operations": 0.0, "bytes": 0.0}
        self.max_abs_err = 0.0

    def add(self, count, ms, plain, lib, flops, nbytes, err):
        self.ms += ms * count
        self.plain_ms += plain * count
        self.library_ms += lib * count
        b_ms, b_by = bound(flops, nbytes, self.peak)
        self.bound_ms[b_by] += b_ms * count
        self.max_abs_err = max(self.max_abs_err, err)

    def result(self):
        b_by = max(self.bound_ms, key=self.bound_ms.get)
        return dict(ms=self.ms, plain_ms=self.plain_ms,
                    library_ms=self.library_ms,
                    bound_ms=sum(self.bound_ms.values()), bound_by=b_by,
                    max_abs_err=self.max_abs_err)


def _line(what, count, ms, plain, lib, flops, nbytes, err,
          peak=PEAK_F32_FLOPS):
    b_ms, b_by = bound(flops, nbytes, peak)
    log(f"  {what} x{count}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"library {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"{flops / ms / 1e9:.2f} TFLOP/s, {nbytes / ms / 1e6:.1f} GB/s, "
        f"max err {err:.2e}")


def phase_conv_kernels(dev, serve_shapes, train_shapes, randn):
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input, conv2d_weight

    from paddle_tpu_torch.kernels import conv as kconv

    # the serving path's check: the forward at the serving bucket and at ragged
    # batches
    serve = _Sum()
    serve_simt = 0.0
    log("conv2d_nhwc at the serving bucket (kernel vs plain vs F.conv2d, "
        "TF32 off; the SIMT tile beside the split-TF32 engine), per call:")
    for (n, h, w, c, o, k), count in sorted(serve_shapes.items()):
        x = randn(n, h, w, c)
        wt = randn(k, k, c, o, scale=(2.0 / (k * k * c)) ** 0.5)
        want = kconv.conv2d_nhwc_plain(x, wt, k // 2)
        err = check_close(f"conv {(n, h, w, c, o, k)}",
                          kconv.conv2d_nhwc(x, wt, k // 2), want, **GEMM_TOL)
        w_lib = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        ms = time_ms(lambda: kconv.conv2d_nhwc(x, wt, k // 2))
        plain = time_ms(lambda: kconv.conv2d_nhwc_plain(x, wt, k // 2))
        lib = time_ms(lambda: F.conv2d(x.permute(0, 3, 1, 2), w_lib,
                                       padding=k // 2))
        flops = 2.0 * n * h * w * o * k * k * c
        nbytes = 4.0 * (n * h * w * c + k * k * c * o + n * h * w * o)
        _line(f"N{n} {h}x{w} {c}->{o} k{k}", count, ms, plain, lib, flops,
              nbytes, err)
        serve.add(count, ms, plain, lib, flops, nbytes, err)
        serve_simt += count * _old_tile(
            f"conv {(n, h, w, c, o, k)}", want, ms, flops,
            lambda: kconv._launch_conv(x, wt, k // 2, "conv", engine="simt"),
            kconv.f32_engine(c, o, x.data_ptr(), wt.data_ptr()),
            lambda name, got, want: check_close(name, got, want, **GEMM_TOL),
            "SIMT")
    for n in (1, 3):
        for (h, c, o, k) in ((56, 64, 64, 3), (28, 128, 128, 3),
                             (14, 256, 256, 3), (7, 512, 512, 3),
                             (56, 64, 256, 1), (7, 2048, 512, 1)):
            x = randn(n, h, h, c)
            wt = randn(k, k, c, o, scale=(2.0 / (k * k * c)) ** 0.5)
            serve.max_abs_err = max(serve.max_abs_err, check_close(
                f"conv {(n, h, h, c, o, k)}", kconv.conv2d_nhwc(x, wt, k // 2),
                kconv.conv2d_nhwc_plain(x, wt, k // 2), **GEMM_TOL))
    r = serve.result()
    log(f"  one serving forward's conv launches: kernel {r['ms']:.3f} ms, "
        f"plain {r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms, "
        f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}); the SIMT tile "
        f"{serve_simt:.3f} ms; max err {r['max_abs_err']:.2e} (tolerance "
        f"{GEMM_TOL})")

    # the training step: forward, backward-input and filter gradient of
    # every kernel conv at batch 256
    sums = {k: _Sum() for k in ("conv2d_nhwc", "conv_bwd_input", "conv_dw")}
    # the SIMT tile of the forward, backward-input and filter gradient
    # (what the split-TF32 engine replaced), their bound as split TF32, the
    # filter gradient's split pass
    simt = dict(conv2d_nhwc=0.0, conv_bwd_input=0.0, conv_dw=0.0)
    bound_tf32 = dw_pass = 0.0
    log(f"conv kernels of the training step at batch {TRAIN_BATCH} (fwd: "
        "F.conv2d; bwd-input: conv2d_input; filter grad: conv2d_weight; "
        "TF32 off), per call:")
    for (n, h, w, c, o, k), count in sorted(train_shapes.items()):
        p = k // 2
        x = randn(n, h, w, c)
        wt = randn(k, k, c, o, scale=(2.0 / (k * k * c)) ** 0.5)
        g = randn(n, h, w, o)
        x_lib, g_lib = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        w_lib = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        flops = 2.0 * n * h * w * o * k * k * c
        nbytes = 4.0 * (n * h * w * c + k * k * c * o + n * h * w * o)
        tag = f"N{n} {h}x{w} {c}->{o} k{k}"

        close = (lambda name, got, want:
                 check_close(name, got, want, **GEMM_TOL))
        bound_tf32 += count * 3 * flops / PEAK_TF32_FLOPS * 1e3
        want = kconv.conv2d_nhwc_plain(x, wt, p)
        err = check_close(f"conv {tag}", kconv.conv2d_nhwc(x, wt, p), want,
                          **GEMM_TOL)
        times = (time_ms(lambda: kconv.conv2d_nhwc(x, wt, p)),
                 time_ms(lambda: kconv.conv2d_nhwc_plain(x, wt, p)),
                 time_ms(lambda: F.conv2d(x_lib, w_lib, padding=p)))
        _line(f"fwd {tag}", count, *times, flops, nbytes, err)
        sums["conv2d_nhwc"].add(count, *times, flops, nbytes, err)
        simt["conv2d_nhwc"] += count * _old_tile(
            f"conv {tag}", want, times[0], flops,
            lambda: kconv._launch_conv(x, wt, p, "conv", engine="simt"),
            kconv.f32_engine(c, o, x.data_ptr(), wt.data_ptr()), close,
            "SIMT")

        want = kconv.conv2d_nhwc_bwd_input_plain(g, wt, p)
        err = check_close(f"conv bwd-input {tag}",
                          kconv.conv2d_nhwc_bwd_input(g, wt, p), want,
                          **GEMM_TOL)
        times = (time_ms(lambda: kconv.conv2d_nhwc_bwd_input(g, wt, p)),
                 time_ms(lambda: kconv.conv2d_nhwc_bwd_input_plain(g, wt, p)),
                 time_ms(lambda: conv2d_input(x_lib.shape, w_lib, g_lib,
                                              padding=p)))
        _line(f"bwd-input {tag}", count, *times, flops, nbytes, err)
        sums["conv_bwd_input"].add(count, *times, flops, nbytes, err)
        # the wrapper's own work on the SIMT tile: the filter's flip, a
        # launch
        simt["conv_bwd_input"] += count * _old_tile(
            f"conv bwd-input {tag}", want, times[0], flops,
            lambda: kconv._launch_conv(g, kconv.flip_filter(wt), p, "conv",
                                       engine="simt"),
            kconv.f32_engine(o, c, g.data_ptr(), wt.data_ptr()), close,
            "SIMT")
        del want
        if (h, c, k) in ((7, 512, 3), (7, 2048, 1)):
            # the float64 gate: a 3 x 3 conv with K 4608 and a 1 x 1 with
            # C 2048, forward and backward-input
            _gemm_f64_precision(
                f"conv {tag}",
                kconv._launch_conv(x, wt, p, "conv", engine="wgmma"),
                kconv._launch_conv(x, wt, p, "conv", engine="simt"),
                _conv_f64(x, wt, p))
            wf = kconv.flip_filter(wt)
            _gemm_f64_precision(
                f"conv bwd-input {tag}",
                kconv._launch_conv(g, wt, p, "conv", engine="wgmma",
                                   flip=True),
                kconv._launch_conv(g, wf, p, "conv", engine="simt"),
                _conv_f64(g, wf, p))
            del wf

        want = kconv.conv2d_nhwc_dw_plain(x, g, k, p)
        err = check_scaled(f"conv filter grad {tag}",
                           kconv.conv2d_nhwc_dw(x, g, k, p), want, DW_TOL)
        times = (time_ms(lambda: kconv.conv2d_nhwc_dw(x, g, k, p)),
                 time_ms(lambda: kconv.conv2d_nhwc_dw_plain(x, g, k, p)),
                 time_ms(lambda: conv2d_weight(x_lib, w_lib.shape, g_lib,
                                               padding=p)))
        engine = kconv.f32_dw_engine(c, o, x.data_ptr(), g.data_ptr())
        splits, chunk = (
            kconv.dw_splits_tf32(k * k * c, o, kconv.dw_pixels(n, h, w, p))
            if engine == "wgmma" else kconv.dw_splits(k * k * c, o, n * h * w))
        _line(f"filter grad {tag} ({splits} splits of {chunk} positions)",
              count, *times, flops, nbytes, err)
        sums["conv_dw"].add(count, *times, flops, nbytes, err)
        # the SIMT tile the split-TF32 engine replaced; the engine's device
        # time split into its split pass, products and reduce
        simt["conv_dw"] += count * _old_tile(
            f"conv filter grad {tag}", want, times[0], flops,
            lambda: kconv._launch_dw(x, g, k, p, "simt"), engine,
            lambda name, got, want: check_scaled(name, got, want, DW_TOL),
            "SIMT")
        parts = device_ms(lambda: kconv.conv2d_nhwc_dw(x, g, k, p), reps=3)
        split_ms = sum(v for n_, v in parts.items() if "split_dw" in n_)
        prod_ms = sum(v for n_, v in parts.items() if "tf32_dw_kernel" in n_)
        rest_ms = sum(parts.values()) - split_ms - prod_ms
        dw_pass += count * split_ms
        log(f"    device time a call: split pass {split_ms:.4f} ms, products"
            f" {prod_ms:.4f} ms, the rest {rest_ms:.4f} ms")
        if (h, c, o, k) in ((7, 512, 512, 3), (56, 64, 256, 1)):
            # the float64 gate: the longest filter-gradient K (1 x 1 at
            # 56 x 56) and a 3 x 3 at C 512
            _gemm_f64_precision(
                f"conv filter grad {tag}",
                kconv._launch_dw(x, g, k, p, "wgmma"),
                kconv._launch_dw(x, g, k, p, "simt"), _dw_f64(x, g, k, p))
        del x, wt, g, x_lib, g_lib, w_lib, want
    torch.cuda.empty_cache()
    results = {name: s.result() for name, s in sums.items()}
    for name, ms in simt.items():
        results[name].update(simt_ms=ms, bound_tf32_ms=bound_tf32)
    results["conv_dw"]["split_pass_ms"] = dw_pass
    for name, r in results.items():
        log(f"  one training step's {name} launches: kernel {r['ms']:.3f} ms,"
            f" plain {r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms,"
            f" bound {r['bound_ms']:.3f} ms ({r['bound_by']})"
            + (f", {r['bound_tf32_ms']:.3f} ms as split TF32; the SIMT tile "
               f"{r['simt_ms']:.3f} ms" if "simt_ms" in r else "")
            + (f"; the split pass {r['split_pass_ms']:.3f} ms of device time"
               if "split_pass_ms" in r else "")
            + f"; max err {r['max_abs_err']:.2e}")
    return results


# the BN kernels' CUDA names in a profile: the two launches of a call,
# and the three launches of the earlier three-launch design
BN_KERNELS = {
    ("fwd", "two"): ("bn_fwd_stats_kernel", "bn_fwd_apply_kernel"),
    ("bwd", "two"): ("bn_bwd_stats_kernel", "bn_bwd_apply_kernel"),
    ("fwd", "three"): ("bn_fwd_partial_kernel", "bn_fwd_finalize_kernel",
                       "bn_fwd_normalize_kernel"),
    ("bwd", "three"): ("bn_bwd_partial_kernel", "bn_bwd_finalize_kernel",
                       "bn_bwd_dx_kernel"),
}
# bytes a BN call moves at least, in passes over R x C: x cannot stay on
# the chip between its two launches (forward x, x, y; backward x, dy, x,
# dy, dx); the bound counts each input and output once (2 and 3)
BN_PASSES = {"fwd": 3, "bwd": 5}


def host_us(fn, batches=5, calls=20):
    """The host's microseconds a call of ``fn`` (the wrapper's own work up
    to its last launch): the median over ``batches`` of ``calls`` calls
    queued back to back after a synchronise; the card runs behind.  Late
    in this process, after profiled windows, launches cost the host more
    than in a fresh one (scripts/bn_variants.py measures before any)."""
    import torch

    out = []
    for _ in range(batches):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(out)


def _bn_profile(calls, reps=5):
    """{(direction, design): (device ms a call, kernel launches a call)} of
    ``calls`` ({(direction, design): fn}), from one profiled window of
    ``reps`` calls of each after one unprofiled call of each.  A window
    that saw another count than each design's launches a call (2; the
    three-launch design's 3) is taken again (``cuda_window``); the last
    one is returned, and the caller fails on its counts."""
    import torch

    for fn in calls.values():
        fn()
    torch.cuda.synchronize()

    def body():
        for fn in calls.values():
            for _ in range(reps):
                fn()

    def tally(events):
        out = {}
        for key in calls:
            hits = [e for e in events if any(
                f"{k}<" in e.key or f"{k}(" in e.key
                for k in BN_KERNELS[key])]
            out[key] = (
                sum(e.self_device_time_total for e in hits) / 1e3 / reps,
                sum(e.count for e in hits) / reps)
        return out

    def right(events):
        return all(n == len(BN_KERNELS[key])
                   for key, (_, n) in tally(events).items())

    return tally(cuda_window(body, right, "profiled BN calls"))


def phase_bn_instance(dtype, bn_shapes, randn):
    """The BN forward and backward in ``dtype`` at every distinct BN shape
    of the ResNet-50 step at batch 256: each against its plain version
    (float32 within BN_TOL, bf16 by check_bf16, the vectors within
    BN_VEC_TOL of max), two calls bit for bit; CUDA-event medians of the
    wrapper, the plain version and the library call (F.batch_norm, and
    native_batch_norm_backward as its autograd runs it, on channels-last
    tensors); the device-only time and launches a call of the kernels and
    of the earlier three-launch design (one profiled window a shape) and
    that design's event time; the wrapper's host microseconds a call; the
    bytes moved a second of device time.  Returns the two instances' rows
    of the kernels line."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import batch_norm as kbn

    bf16 = dtype == torch.bfloat16
    size = 2 if bf16 else 4
    suffix = "_bf16" if bf16 else ""
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
    sums = {d: _Sum(peak) for d in ("fwd", "bwd")}
    extra = {d: dict(device_ms=0.0, three_pass_ms=0.0,
                     three_pass_device_ms=0.0, host_us=0.0, moved_bytes=0.0)
             for d in ("fwd", "bwd")}
    calls = 0
    log(f"{'bf16 ' if bf16 else ''}batch-norm kernels of the "
        f"{'AMP ' if bf16 else ''}training step at batch {TRAIN_BATCH} (fwd: "
        "F.batch_norm(training=True); bwd: native_batch_norm_backward, its "
        "autograd backward; channels-last inputs, f32 gamma and beta; "
        "device = the kernels' own time, two launches a call; three-pass = "
        "the earlier three-launch design), per call:")
    for (n, h, w, c), count in sorted(bn_shapes.items()):
        rows = n * h * w
        x = (randn(rows, c, scale=2.0) + 0.5).to(dtype)
        gamma, beta = randn(c), randn(c)
        dy = randn(rows, c).to(dtype)
        x4 = x.reshape(n, h, w, c).permute(0, 3, 1, 2)
        dy4 = dy.reshape(n, h, w, c).permute(0, 3, 1, 2)
        tag = f"{'bf16 ' if bf16 else ''}R{rows} C{c}"

        def close(what, got, want):
            return (check_bf16(what, got, want) if bf16
                    else check_close(what, got, want, **BN_TOL))

        y, m, v = kbn.batch_norm_fwd(x, gamma, beta, BN_EPS)
        py, pm, pv = kbn.batch_norm_fwd_plain(x, gamma, beta, BN_EPS)
        err_f = close(f"bn fwd {tag}", y, py)
        check_scaled(f"bn mean {tag}", m, pm, BN_VEC_TOL)
        check_scaled(f"bn var {tag}", v, pv, BN_VEC_TOL)
        inv = torch.rsqrt(v + BN_EPS)
        dx, dg, db = kbn.batch_norm_bwd(x, dy, gamma, m, inv)
        pdx, pdg, pdb = kbn.batch_norm_bwd_plain(x, dy, gamma, m, inv)
        err_b = close(f"bn bwd {tag}", dx, pdx)
        check_scaled(f"bn dgamma {tag}", dg, pdg, BN_VEC_TOL)
        check_scaled(f"bn dbeta {tag}", db, pdb, BN_VEC_TOL)
        again = (kbn.batch_norm_fwd(x, gamma, beta, BN_EPS)
                 + kbn.batch_norm_bwd(x, dy, gamma, m, inv))
        if not all(torch.equal(a, b) for a, b in
                   zip((y, m, v, dx, dg, db), again)):
            fail(f"bn {tag}: two calls on the same inputs differ")
        # the earlier design on the same inputs, held to the same plain
        # results
        ty, tm, tv = kbn._launch_fwd(x, gamma, beta, BN_EPS, "three-pass")
        close(f"bn fwd {tag} (three-pass)", ty, py)
        check_scaled(f"bn var {tag} (three-pass)", tv, pv, BN_VEC_TOL)
        tdx = kbn._launch_bwd(x, dy, gamma, m, inv, "three-pass")[0]
        close(f"bn bwd {tag} (three-pass)", tdx, pdx)
        del y, py, dx, pdx, again, ty, tdx

        fns = {
            ("fwd", "two"): lambda: kbn.batch_norm_fwd(x, gamma, beta,
                                                       BN_EPS),
            ("bwd", "two"): lambda: kbn.batch_norm_bwd(x, dy, gamma, m, inv),
            ("fwd", "three"): lambda: kbn._launch_fwd(x, gamma, beta, BN_EPS,
                                                      "three-pass"),
            ("bwd", "three"): lambda: kbn._launch_bwd(x, dy, gamma, m, inv,
                                                      "three-pass"),
        }
        plain = {"fwd": lambda: kbn.batch_norm_fwd_plain(x, gamma, beta,
                                                         BN_EPS),
                 "bwd": lambda: kbn.batch_norm_bwd_plain(x, dy, gamma, m,
                                                         inv)}
        library = {
            "fwd": lambda: F.batch_norm(x4, None, None, gamma, beta,
                                        training=True, eps=BN_EPS),
            "bwd": lambda: torch.ops.aten.native_batch_norm_backward(
                dy4, x4, gamma, None, None, m, inv, True, BN_EPS,
                [True, True, True])}
        prof = _bn_profile(fns)
        for d, err, flops, nbytes in (
                ("fwd", err_f, 5.0 * rows * c, 2.0 * rows * c * size),
                ("bwd", err_b, 8.0 * rows * c, 3.0 * rows * c * size)):
            dev_ms, per_call = prof[(d, "two")]
            old_dev, old_per_call = prof[(d, "three")]
            if (per_call, old_per_call) != (2, 3):
                fail(f"bn {d} {tag}: the profiler saw {per_call} launches a "
                     f"call ({old_per_call} for the three-launch design), "
                     "not 2 (3)")
            times = (time_ms(fns[(d, "two")]),
                     time_ms(plain[d], reps=5 if bf16 else 10),
                     time_ms(library[d]))
            old_ms = time_ms(fns[(d, "three")])
            host = host_us(fns[(d, "two")])
            moved = BN_PASSES[d] * rows * c * size
            b_ms, _ = bound(flops, nbytes, peak)
            _line(f"{d} {tag}", count, *times, flops, nbytes, err, peak)
            log(f"    device {dev_ms:.4f} ms ({moved / dev_ms / 1e6:.1f} GB/s "
                f"over {BN_PASSES[d]} passes, {nbytes / dev_ms / 1e6:.1f} "
                f"GB/s of the bound's bytes; {b_ms / dev_ms:.0%} of the "
                f"bound); three-pass {old_ms:.4f} ms, device {old_dev:.4f} ms"
                f" ({old_dev / dev_ms:.2f}x); host {host:.1f} us a call")
            sums[d].add(count, *times, flops, nbytes, err)
            for k, val in (("device_ms", dev_ms), ("three_pass_ms", old_ms),
                           ("three_pass_device_ms", old_dev),
                           ("host_us", host), ("moved_bytes", moved)):
                extra[d][k] += count * val
        calls += count
        del x, dy, x4, dy4
    torch.cuda.empty_cache()
    results = {}
    for d, name in (("fwd", "batch_norm_fwd"), ("bwd", "batch_norm_bwd")):
        r = sums[d].result()
        e = extra[d]
        r.update(device_ms=e["device_ms"], three_pass_ms=e["three_pass_ms"],
                 three_pass_device_ms=e["three_pass_device_ms"],
                 host_us=e["host_us"] / calls,
                 moved_gb_per_s=e["moved_bytes"] / e["device_ms"] / 1e6)
        log(f"  one training step's {name + suffix} launches: kernel "
            f"{r['ms']:.3f} ms (device {r['device_ms']:.3f}), plain "
            f"{r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}); the three-launch "
            f"design {r['three_pass_ms']:.3f} ms (device "
            f"{r['three_pass_device_ms']:.3f}); host {r['host_us']:.1f} us a "
            f"call; {r['moved_gb_per_s']:.1f} GB/s moved over "
            f"{BN_PASSES[d]} passes; max err {r['max_abs_err']:.2e} "
            f"(tolerance {'check_bf16' if bf16 else BN_TOL}, vectors "
            f"{BN_VEC_TOL} x max)")
        results[name + suffix] = r
    return results


def phase_dense_kernels(dev, randn):
    """matmul (the fc 2048 -> 1000) and softmax (1000 classes) at 3, 32
    and 256 rows; the kernels line keeps the training step's 256."""
    import torch

    from paddle_tpu_torch.kernels import matmul as kmatmul
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    results = {}
    max_err = 0.0
    for m in (3, SERVE_BATCH, TRAIN_BATCH):
        x = randn(m, 2048)
        y = randn(2048, 1000, scale=0.03)
        err = check_close(f"matmul {m}x2048x1000", kmatmul.matmul(x, y),
                          kmatmul.matmul_plain(x, y), **GEMM_TOL)
        max_err = max(max_err, err)
        ms = time_ms(lambda: kmatmul.matmul(x, y))
        plain = time_ms(lambda: kmatmul.matmul_plain(x, y))
        lib = time_ms(lambda: torch.matmul(x, y))
        b_ms, b_by = bound(2.0 * m * 2048 * 1000,
                           4.0 * (m * 2048 + 2048 * 1000 + m * 1000))
        log(f"matmul {m}x2048x1000: kernel {ms:.4f} ms, plain {plain:.4f} ms,"
            f" library {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}), max err "
            f"{err:.2e} (tolerance {GEMM_TOL})")
    results["matmul"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                             bound_ms=b_ms, bound_by=b_by, max_abs_err=max_err)

    max_err = 0.0
    for rows in (3, SERVE_BATCH, TRAIN_BATCH):
        x = randn(rows, 1000, scale=4.0)
        err = check_close(f"softmax {rows}x1000", ksoftmax.softmax(x),
                          ksoftmax.softmax_plain(x), rtol=0,
                          atol=SOFTMAX_ATOL)
        max_err = max(max_err, err)
        ms = time_ms(lambda: ksoftmax.softmax(x))
        plain = time_ms(lambda: ksoftmax.softmax_plain(x))
        lib = time_ms(lambda: torch.softmax(x, dim=-1))
        b_ms, b_by = bound(5.0 * rows * 1000, 8.0 * rows * 1000)
        log(f"softmax {rows}x1000: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"library {lib:.4f} ms, bound {b_ms:.5f} ms ({b_by}), max err "
            f"{err:.2e} (tolerance atol {SOFTMAX_ATOL})")
    y = ksoftmax.softmax(x)
    route = ksoftmax.softmax_route(*x.shape, x.data_ptr(), y.data_ptr())
    host = host_us(lambda: ksoftmax.softmax(x))
    lib_host = host_us(lambda: torch.softmax(x, dim=-1))
    cold = cold_device_ms(lambda: ksoftmax.softmax(x))
    lib_cold = cold_device_ms(lambda: torch.softmax(x, dim=-1))
    log(f"softmax {TRAIN_BATCH}x1000 ({route} route): host {host:.2f} us a "
        f"call (torch.softmax {lib_host:.2f}); device time with the L2 "
        f"flushed {cold:.4f} ms (torch.softmax {lib_cold:.4f})")
    sweep = phase_softmax_sweep(randn)
    wide = sweep[f"{SOFTMAX_SWEEP_ROWS}x30000"]
    results["softmax"] = dict(
        ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
        max_abs_err=max(max_err, *(r["max_abs_err"] for r in sweep.values())),
        kernel_route=route, host_us=host, library_host_us=lib_host,
        cold_device_ms=cold, library_cold_device_ms=lib_cold,
        wide_route=wide["route"], wide_ms=wide["ms"],
        wide_device_ms=wide["device_ms"], wide_library_ms=wide["library_ms"],
        wide_library_device_ms=wide["library_device_ms"],
        wide_bound_ms=wide["bound_ms"], sweep=sweep, **_device_times(
            "softmax", ms, lib, lambda: ksoftmax.softmax(x),
            lambda: torch.softmax(x, dim=-1)))
    return results


def phase_softmax_sweep(randn):
    """The softmax at SOFTMAX_SWEEP_ROWS rows of each SOFTMAX_SWEEP_COLS
    width: the route the rule takes, the kernel against its plain version
    (atol SOFTMAX_ATOL), its event and device times beside
    torch.softmax's, the bound and the shares of it."""
    import torch

    from paddle_tpu_torch.kernels import softmax as ksoftmax

    rows = SOFTMAX_SWEEP_ROWS
    out = {}
    for cols in SOFTMAX_SWEEP_COLS:
        x = randn(rows, cols, scale=4.0)
        y = ksoftmax.softmax(x)
        route, cluster, part = ksoftmax.softmax_plan(cols, x.data_ptr(),
                                                     y.data_ptr())
        err = check_close(f"softmax {rows}x{cols} ({route})", y,
                          ksoftmax.softmax_plain(x), rtol=0,
                          atol=SOFTMAX_ATOL)
        del y
        ms = time_ms(lambda: ksoftmax.softmax(x))
        lib = time_ms(lambda: torch.softmax(x, dim=-1))
        dev = sum(device_ms(lambda: ksoftmax.softmax(x)).values())
        lib_dev = sum(device_ms(lambda: torch.softmax(x, dim=-1)).values())
        b_ms, b_by = bound(5.0 * rows * cols, 8.0 * rows * cols)
        out[f"{rows}x{cols}"] = dict(
            route=route, cluster=cluster, part=part, max_abs_err=err, ms=ms,
            device_ms=dev, library_ms=lib, library_device_ms=lib_dev,
            bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / dev,
            library_bound_share=b_ms / lib_dev)
        log(f"softmax {rows}x{cols}: {route} route (cluster {cluster}, part "
            f"{part}), event {ms:.4f} ms, device {dev:.4f} ms "
            f"({b_ms / dev:.3f} of the bound {b_ms:.4f} ms, {b_by}); "
            "torch.softmax event "
            f"{lib:.4f} ms, device {lib_dev:.4f} ms ({b_ms / lib_dev:.3f}); "
            f"max err {err:.2e}")
        del x
        torch.cuda.empty_cache()
    return out


def _device_times(what, ms, lib, kernel, library):
    """A short kernel's device-only time beside its event time (which
    brackets the wrapper's host work too), and the library call's:
    {"device_ms", "library_device_ms"}, summed over each call's kernels
    (``device_ms``; None where the profiler saw none)."""
    got = [sum(device_ms(fn).values()) or None for fn in (kernel, library)]
    log(f"  {what}: device time {got[0]} ms (event time {ms:.4f}), library "
        f"{got[1]} ms (event time {lib:.4f})")
    return dict(device_ms=got[0], library_device_ms=got[1])


def check_bf16(name, got, want):
    """|kernel - plain| <= BF16_RTOL * |plain| + BF16_ATOL * max|plain|
    for a bf16 output; returns the max abs err."""
    import torch

    if got.dtype != torch.bfloat16 or want.dtype != torch.bfloat16:
        fail(f"{name}: dtypes {got.dtype} and {want.dtype}, want bf16")
    g, w = got.double(), want.double()
    err = float((g - w).abs().max()) if w.numel() else 0.0
    atol = BF16_ATOL * float(w.abs().max()) if w.numel() else 0.0
    if not bool(((g - w).abs() <= BF16_RTOL * w.abs() + atol).all()):
        fail(f"{name}: kernel disagrees with its plain version (max abs err "
             f"{err:.3e}, tolerance rtol {BF16_RTOL} + {BF16_ATOL} x max)")
    return err


def _old_tile(what, want, ms, flops, launch_tile, engine, check=check_bf16,
              name="mma.sync"):
    """The ``name`` tile (the bf16 mma.sync or the f32 SIMT one) beside the
    kernel the wrapper launched (``engine``) at one shape: held against
    the same plain result by ``check`` (name, got, want), timed alone;
    returns its ms."""
    err = check(f"{what} ({name} tile)", launch_tile(), want)
    tile = time_ms(launch_tile, reps=5)
    log(f"    {engine} engine {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s); "
        f"the {name} tile {tile:.4f} ms ({flops / tile / 1e9:.1f} "
        f"TFLOP/s, max err {err:.2e}): {tile / ms:.2f}x")
    return tile


def phase_bf16_kernels(dev, train_shapes, bn_shapes, randn):
    """The AMP step's bf16 instances at every distinct shape the ResNet-50
    step at batch 256 gives them, and the fused conv + BN statistics at
    its two shapes in float32 and bf16."""
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input, conv2d_weight

    from paddle_tpu_torch.kernels import conv as kconv
    from paddle_tpu_torch.kernels import matmul as kmatmul

    bf = torch.bfloat16
    sums = {k: _Sum(PEAK_BF16_FLOPS) for k in (
        "conv2d_nhwc_bf16", "conv_bwd_input_bf16", "conv_dw_bf16")}
    # the same launches on the mma.sync tile, for the wgmma engine's gain
    tile_ms = dict(conv2d_nhwc_bf16=0.0, conv_bwd_input_bf16=0.0,
                   conv_dw_bf16=0.0)
    log(f"bf16 conv kernels of the AMP step at batch {TRAIN_BATCH} (fwd: "
        "F.conv2d on channels-last bf16; bwd-input: conv2d_input; filter "
        "grad: conv2d_weight; bound at 989 TFLOP/s bf16), per call:")
    for (n, h, w, c, o, k), count in sorted(train_shapes.items()):
        p = k // 2
        x = randn(n, h, w, c).to(bf)
        wt = randn(k, k, c, o, scale=(2.0 / (k * k * c)) ** 0.5).to(bf)
        g = randn(n, h, w, o).to(bf)
        x_lib, g_lib = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        w_lib = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        flops = 2.0 * n * h * w * o * k * k * c
        nbytes = 2.0 * (n * h * w * c + k * k * c * o + n * h * w * o)
        tag = f"N{n} {h}x{w} {c}->{o} k{k}"

        want = kconv.conv2d_nhwc_plain(x, wt, p)
        err = check_bf16(f"bf16 conv {tag}", kconv.conv2d_nhwc(x, wt, p),
                         want)
        times = (time_ms(lambda: kconv.conv2d_nhwc(x, wt, p)),
                 time_ms(lambda: kconv.conv2d_nhwc_plain(x, wt, p), reps=5),
                 time_ms(lambda: F.conv2d(x_lib, w_lib, padding=p)))
        _line(f"bf16 fwd {tag}", count, *times, flops, nbytes, err,
              PEAK_BF16_FLOPS)
        sums["conv2d_nhwc_bf16"].add(count, *times, flops, nbytes, err)
        tile_ms["conv2d_nhwc_bf16"] += count * _old_tile(
            f"bf16 conv {tag}", want, times[0], flops,
            lambda: kconv._launch_conv(x, wt, p, "conv", engine="mma.sync"),
            kconv.bf16_engine(c, o, x.data_ptr(), wt.data_ptr()))

        want = kconv.conv2d_nhwc_bwd_input_plain(g, wt, p)
        err = check_bf16(f"bf16 conv bwd-input {tag}",
                         kconv.conv2d_nhwc_bwd_input(g, wt, p), want)
        times = (time_ms(lambda: kconv.conv2d_nhwc_bwd_input(g, wt, p)),
                 time_ms(lambda: kconv.conv2d_nhwc_bwd_input_plain(g, wt, p),
                         reps=5),
                 time_ms(lambda: conv2d_input(x_lib.shape, w_lib, g_lib,
                                              padding=p)))
        _line(f"bf16 bwd-input {tag}", count, *times, flops, nbytes, err,
              PEAK_BF16_FLOPS)
        sums["conv_bwd_input_bf16"].add(count, *times, flops, nbytes, err)
        # the wrapper's own work on the tile: the filter's flip, a launch
        tile_ms["conv_bwd_input_bf16"] += count * _old_tile(
            f"bf16 conv bwd-input {tag}", want, times[0], flops,
            lambda: kconv._launch_conv(g, kconv.flip_filter(wt), p, "conv",
                                       engine="mma.sync"),
            kconv.bf16_engine(o, c, g.data_ptr(), wt.data_ptr()))
        del want

        # the filter gradient is f32 (KH, KW, C, O): 4 bytes an element
        dw_bytes = 2.0 * (n * h * w * c + n * h * w * o) + 4.0 * k * k * c * o
        want = kconv.conv2d_nhwc_dw_plain(x, g, k, p)
        err = check_scaled(f"bf16 conv filter grad {tag}",
                           kconv.conv2d_nhwc_dw(x, g, k, p), want, DW_TOL)
        times = (time_ms(lambda: kconv.conv2d_nhwc_dw(x, g, k, p)),
                 time_ms(lambda: kconv.conv2d_nhwc_dw_plain(x, g, k, p),
                         reps=5),
                 time_ms(lambda: conv2d_weight(x_lib, w_lib.shape, g_lib,
                                               padding=p)))
        engine = kconv.bf16_engine(c, o, x.data_ptr(), g.data_ptr())
        splits, chunk = (kconv.dw_splits_wgmma(k * k * c, o, n * h * w)
                         if engine == "wgmma" else (0, 0))
        _line(f"bf16 filter grad {tag} ({splits} splits of {chunk} pixels)",
              count, *times, flops, dw_bytes, err, PEAK_BF16_FLOPS)
        sums["conv_dw_bf16"].add(count, *times, flops, dw_bytes, err)
        tile_ms["conv_dw_bf16"] += count * _old_tile(
            f"bf16 conv filter grad {tag}", want, times[0], flops,
            lambda: kconv._launch_dw(x, g, k, p, "mma.sync"), engine,
            lambda name, got, want: check_scaled(name, got, want, DW_TOL))
        del x, wt, g, x_lib, g_lib, w_lib, want

    torch.cuda.empty_cache()
    results = {name: s.result() for name, s in sums.items()}
    for name, ms in tile_ms.items():
        results[name]["mma_sync_ms"] = ms
    results.update(phase_bn_instance(bf, bn_shapes, randn))

    x = randn(TRAIN_BATCH, 2048).to(bf)
    y = randn(2048, 1000, scale=0.03).to(bf)
    err = check_bf16(f"bf16 matmul {TRAIN_BATCH}x2048x1000",
                     kmatmul.matmul(x, y), kmatmul.matmul_plain(x, y))
    times = (time_ms(lambda: kmatmul.matmul(x, y)),
             time_ms(lambda: kmatmul.matmul_plain(x, y)),
             time_ms(lambda: torch.matmul(x, y)))
    flops = 2.0 * TRAIN_BATCH * 2048 * 1000
    nbytes = 2.0 * (TRAIN_BATCH * 2048 + 2048 * 1000 + TRAIN_BATCH * 1000)
    _line(f"bf16 matmul {TRAIN_BATCH}x2048x1000", 1, *times, flops, nbytes,
          err, PEAK_BF16_FLOPS)
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    results["matmul_bf16"] = dict(ms=times[0], plain_ms=times[1],
                                  library_ms=times[2], bound_ms=b_ms,
                                  bound_by=b_by, max_abs_err=err)

    results.update(phase_conv_stats(randn))
    torch.cuda.empty_cache()
    for name, r in results.items():
        log(f"  {name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms,"
            f" library {r['library_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})"
            + (f", {r['bound_tf32_ms']:.4f} ms as split TF32"
               if "bound_tf32_ms" in r else "")
            + (f"; the old tile {r['tile_ms']:.3f} ms, the plain conv on the "
               f"same engine {r['conv_ms']:.3f} ms" if "tile_ms" in r else "")
            + f"; max err {r['max_abs_err']:.2e}")
    return results


def phase_conv_stats(randn):
    """The fused conv + BN statistics (row 1b; no op calls it) in f32 and
    bf16 at STATS_SHAPES, per call at each shape, summed over the two:
    launched on the plain conv's engine (wgmma at both shapes, checked by
    its counters), held against the plain version (out, mean, var), bit
    for bit across two calls, beside the old tile (``tile_ms``, by name),
    the plain conv on the same engine (``conv_ms``: what the statistics
    epilogue adds), the library (F.conv2d + torch.var_mean) and, for
    f32, the split-TF32 bound (``bound_tf32_ms``)."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import conv as kconv

    bf = torch.bfloat16
    results = {}
    for dtype, name in ((torch.float32, "conv2d_bn_stats"),
                        (bf, "conv2d_bn_stats_bf16")):
        total = _Sum(PEAK_BF16_FLOPS if dtype == bf else PEAK_F32_FLOPS)
        tile = "mma.sync" if dtype == bf else "simt"
        tile_sum = conv_sum = tf32_sum = dev_sum = conv_dev_sum = 0.0
        size = 2 if dtype == bf else 4
        log(f"{name} (conv + BN statistics; library F.conv2d + "
            "torch.var_mean of its output), per call:")
        for (n, h, w, c, o, k) in STATS_SHAPES:
            p = k // 2
            x = (randn(n, h, w, c) + 0.2).to(dtype)
            wt = randn(k, k, c, o, scale=(2.0 / (k * k * c)) ** 0.5).to(dtype)
            x_lib = x.permute(0, 3, 1, 2)
            w_lib = wt.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            tag = f"N{n} {h}x{w} {c}->{o} k{k}"
            on = (wgmma_counters()[name], counters()[name])
            out, mean, var = kconv.conv2d_bn_stats_nhwc(x, wt, p)
            if (wgmma_counters()[name], counters()[name]) != (on[0] + 1,
                                                              on[1] + 1):
                fail(f"{name} {tag}: not launched on the wgmma engine")
            pout, pmean, pvar = kconv.conv2d_bn_stats_nhwc_plain(x, wt, p)
            check = (check_bf16 if dtype == bf else
                     (lambda what, got, want:
                      check_close(what, got, want, **GEMM_TOL)))
            err = check(f"{name} {tag}", out, pout)
            check_scaled(f"{name} mean {tag}", mean, pmean, STATS_TOL)
            check_scaled(f"{name} var {tag}", var, pvar, STATS_TOL)
            old = kconv._launch_conv(x, wt, p, name, stats=True, engine=tile)
            check(f"{name} {tag} ({tile} tile)", old[0], pout)
            check_scaled(f"{name} mean {tag} ({tile} tile)", old[1], pmean,
                         STATS_TOL)
            check_scaled(f"{name} var {tag} ({tile} tile)", old[2], pvar,
                         STATS_TOL)
            # bit for bit across calls (no atomics)
            again = kconv.conv2d_bn_stats_nhwc(x, wt, p)
            if not all(torch.equal(a, b) for a, b in zip(again,
                                                         (out, mean, var))):
                fail(f"{name} {tag}: two calls differ")

            def library():
                o_ = F.conv2d(x_lib, w_lib, padding=p)
                return torch.var_mean(o_.float(), dim=(0, 2, 3),
                                      unbiased=False)

            times = (time_ms(lambda: kconv.conv2d_bn_stats_nhwc(x, wt, p)),
                     time_ms(lambda: kconv.conv2d_bn_stats_nhwc_plain(
                         x, wt, p), reps=5),
                     time_ms(library))
            t_ms = time_ms(lambda: kconv._launch_conv(
                x, wt, p, name, stats=True, engine=tile), reps=5)
            c_ms = time_ms(lambda: kconv._launch_conv(x, wt, p, name,
                                                      engine="wgmma"))
            flops = 2.0 * n * h * w * o * k * k * c + 3.0 * n * h * w * o
            nbytes = (size * (n * h * w * c + k * k * c * o + n * h * w * o)
                      + 8.0 * o)
            b_tf32 = 3 * 2.0 * n * h * w * o * k * k * c / PEAK_TF32_FLOPS * 1e3
            _line(f"{name} {tag}", 1, *times, flops, nbytes, err, total.peak)
            log(f"    wgmma engine {times[0]:.4f} ms "
                f"({flops / times[0] / 1e9:.1f} TFLOP/s); the {tile} tile "
                f"{t_ms:.4f} ms ({t_ms / times[0]:.2f}x); the plain conv on "
                f"the same engine {c_ms:.4f} ms (event times, host work "
                "included)"
                + ("" if dtype == bf else
                   f"; split-TF32 bound {b_tf32:.4f} ms"))
            parts = device_ms(lambda: kconv.conv2d_bn_stats_nhwc(x, wt, p),
                              reps=3)
            conv_dev = sum(device_ms(lambda: kconv._launch_conv(
                x, wt, p, name, engine="wgmma"), reps=3).values())
            log("    device time a call: " + ", ".join(
                f"{kernel_name(k_)} {v:.4f} ms"
                for k_, v in sorted(parts.items(), key=lambda kv: -kv[1]))
                + f"; the plain conv's {conv_dev:.4f} ms (the statistics add "
                f"{100 * (sum(parts.values()) / conv_dev - 1):.1f}% of device "
                "time)")
            dev_sum += sum(parts.values())
            conv_dev_sum += conv_dev
            total.add(1, *times, flops, nbytes, err)
            tile_sum += t_ms
            conv_sum += c_ms
            tf32_sum += b_tf32
            del x, wt, x_lib, w_lib, out, pout, old, again
        results[name] = total.result()
        results[name].update(tile_ms=tile_sum, conv_ms=conv_sum,
                             device_ms=dev_sum, conv_device_ms=conv_dev_sum)
        if dtype != bf:
            results[name]["bound_tf32_ms"] = tf32_sum
    return results


def _qkv_views(randn, b, s, h, d):
    """q, k, v as the strided views split + reshape leave of one fused
    (B, S, 3 * H * D) projection, the main path's layout."""
    qkv = randn(b, s, 3 * h * d)
    return [t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=2)]


def phase_flash_kernels(dev, randn, bf16=False):
    """The three flash kernels (their bf16 instances with ``bf16``)
    against their plain versions at the transformer step's shape (B 8,
    S 1024, 16 heads of 128, causal) and at ragged shapes (S 200, D 64
    and 72, causal and not), on strided q, k, v views of a fused qkv; the
    plain forward walks the kernel's key tiles, the plain backward takes
    the kernel's own out and lse.  f32: out and lse within FLASH_ATOL,
    the gradients within FLASH_GRAD_TOL of max; bf16: out and the
    gradients within BF16_RTOL / BF16_ATOL, lse within FLASH_ATOL.  Times
    at the step's shape, summed over its 4 launches of each, bound at 67
    TFLOP/s f32 or 989 bf16.  Library: F.scaled_dot_product_attention's
    forward, and its autograd backward (dq, dk and dv together), whose
    kernels one profiled call names.  f32 also: the SIMT forward and
    backward kernels that the split-TF32 ones replaced, checked and timed
    beside them (``simt_ms``), their largest errors against a float64
    forward (at the step's shape and at S 200, D 64) and backward (at the
    step's shape), the split-TF32 one at most FLASH_F64_FACTOR times the
    SIMT one, and the split-TF32 bound, 3 x FLOPs at 495 TFLOP/s
    (``bound_tf32_ms``)."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as kfa

    dt = torch.bfloat16 if bf16 else torch.float32
    sfx = "_bf16" if bf16 else ""
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS

    def close(what, got, want, grad):
        if bf16:
            return check_bf16(what, got, want)
        if grad:
            return check_scaled(what, got, want, FLASH_GRAD_TOL)
        return check_close(what, got, want, rtol=0, atol=FLASH_ATOL)

    def check(tag, b, s, h, d, causal):
        q, k, v = (t.to(dt) for t in _qkv_views(randn, b, s, h, d))
        do = randn(b, s, h, d).to(dt)
        out, lse = kfa.flash_attention_fwd(q, k, v, causal)
        pout, plse = kfa.flash_attention_fwd_plain(q, k, v, causal,
                                                   tile=kfa.key_tile(d))
        err_fwd = max(close(f"flash{sfx} fwd out {tag}", out, pout, False),
                      check_close(f"flash{sfx} fwd lse {tag}", lse, plse,
                                  rtol=0, atol=FLASH_ATOL))
        grads = kfa.flash_attention_bwd(q, k, v, out, lse, do, causal)
        want = kfa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
        errs = [close(f"flash{sfx} {n} {tag}", g, w, True)
                for n, g, w in zip(("dq", "dk", "dv"), grads, want)]
        if not bf16:
            so, sl = kfa._launch_fwd(q, k, v, causal, None, simt=True)
            close(f"flash SIMT fwd out {tag}", so, pout, False)
            check_close(f"flash SIMT fwd lse {tag}", sl, plse, rtol=0,
                        atol=FLASH_ATOL)
            simt = kfa._launch_bwd(q, k, v, out, lse, do, causal, None, None,
                                   simt=True)
            for n, g, w in zip(("dq", "dk", "dv"), simt, want):
                close(f"flash SIMT {n} {tag}", g, w, True)
        return (q, k, v, do, out, lse), [err_fwd, errs[0], max(errs[1:])]

    worst = [0.0, 0.0, 0.0]
    for causal in (False, True):
        for b, h, d in ((1, 6, 64), (2, 3, 72)):
            _, errs = check(f"B{b} S200 H{h} D{d} causal={causal}", b, 200,
                            h, d, causal)
            worst = [max(w, e) for w, e in zip(worst, errs)]
    log(f"flash{sfx} kernels at ragged shapes (S 200, D 64 and 72, causal "
        f"and not): max err fwd {worst[0]:.2e}, dq {worst[1]:.2e}, dk/dv "
        f"{worst[2]:.2e}" + ("" if bf16 else "; the SIMT forward, dq and "
                             "dk/dv within the same tolerance"))

    h, d = TF_CONFIG["num_heads"], TF_CONFIG["d_model"] // TF_CONFIG["num_heads"]
    b, s, count = TF_BATCH, TF_SEQ, TF_CONFIG["num_layers"]
    tag = f"B{b} S{s} H{h} D{d} causal {dt}"
    (q, k, v, do, out, lse), errs = check(tag, b, s, h, d, True)
    worst = [max(w, e) for w, e in zip(worst, errs)]
    ql, kl, vl = (t.detach().transpose(1, 2).requires_grad_(True)
                  for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    lib_do = do.transpose(1, 2)
    fwd_ms = time_ms(lambda: kfa.flash_attention_fwd(q, k, v, True))
    sym = "bf16" if bf16 else "f32"
    dq_ms, dkv_ms = _time_bwd_launches(
        kfa, f"ptt_flash_dq_{sym}", f"ptt_flash_dkv_{sym}",
        lambda: kfa.flash_attention_bwd(q, k, v, out, lse, do, True))
    bwd_ms = time_ms(lambda: kfa.flash_attention_bwd(q, k, v, out, lse, do,
                                                     True))
    plain_fwd = time_ms(lambda: kfa.flash_attention_fwd_plain(
        q, k, v, True, tile=kfa.key_tile(d)), reps=5)
    plain_bwd = time_ms(lambda: kfa.flash_attention_bwd_plain(
        q, k, v, out, lse, do, True), reps=5)
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True))
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), lib_do, retain_graph=True))
    lib_names = _library_kernels(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), lib_do, retain_graph=True))
    log(f"  the library backward ({dt} autograd of F.sdpa) ran: "
        + "; ".join(f"{n} x{c}" for n, c in lib_names))
    # the work: query-key pairs the causal mask keeps, the bytes of one
    # (B, S, H, D) tensor and of one f32 (B*H, S) row array
    pairs = b * h * s * (s + 1) // 2
    tensor, rows = q.element_size() * b * s * h * d, 4.0 * b * h * s
    # (kernel ms, plain ms, library ms, FLOPs, bytes): the plain and
    # library times of dq and dk/dv are each the whole backward
    rows_of = {
        f"flash_attention_fwd{sfx}": (fwd_ms, plain_fwd, lib_fwd,
                                      4.0 * pairs * d, 4 * tensor + rows),
        f"flash_attention_dq{sfx}": (dq_ms, plain_bwd, lib_bwd,
                                     6.0 * pairs * d, 5 * tensor + 2 * rows),
        f"flash_attention_dkv{sfx}": (dkv_ms, plain_bwd, lib_bwd,
                                      8.0 * pairs * d, 6 * tensor + 2 * rows),
    }
    results = {}
    for (name, row), err in zip(rows_of.items(), worst):
        sm = _Sum(peak)
        sm.add(count, *row, err)
        _line(f"{name} {tag}", count, *row, err, peak)
        results[name] = sm.result()
    log(f"  the backward wrapper (delta, dq, dk/dv) {bwd_ms:.4f} ms per call;"
        f" plain and library times of dq and dk/dv are the whole backward")
    if not bf16:
        simt_fwd = time_ms(lambda: kfa._launch_fwd(q, k, v, True, None,
                                                   simt=True), reps=5)
        simt_dq, simt_dkv = _time_bwd_launches(
            kfa, "ptt_flash_dq_f32_simt", "ptt_flash_dkv_f32_simt",
            lambda: kfa._launch_bwd(q, k, v, out, lse, do, True, None, None,
                                    simt=True))
        for name, simt_ms in (("flash_attention_fwd", simt_fwd),
                              ("flash_attention_dq", simt_dq),
                              ("flash_attention_dkv", simt_dkv)):
            r = results[name]
            flops = rows_of[name][3]
            r["simt_ms"] = count * simt_ms
            r["bound_tf32_ms"] = count * 3 * flops / PEAK_TF32_FLOPS * 1e3
            log(f"  {name}: split-TF32 {r['ms']:.3f} ms, the SIMT kernel it "
                f"replaced {r['simt_ms']:.3f} ms "
                f"({r['simt_ms'] / r['ms']:.2f}x) over {count} launches; "
                f"bound {r['bound_ms']:.3f} ms at 67 "
                f"TFLOP/s f32, {r['bound_tf32_ms']:.3f} ms as split TF32 (3 x "
                f"FLOPs at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s)")
        pair = results["flash_attention_dq"], results["flash_attention_dkv"]
        log(f"  dq + dk/dv: split-TF32 {pair[0]['ms'] + pair[1]['ms']:.3f} ms,"
            f" SIMT {pair[0]['simt_ms'] + pair[1]['simt_ms']:.3f} ms, library "
            f"{lib_bwd * count:.3f} ms (whole backward), bound "
            f"{pair[0]['bound_ms'] + pair[1]['bound_ms']:.3f} ms at 67 TFLOP/s"
            f" f32, {pair[0]['bound_tf32_ms'] + pair[1]['bound_tf32_ms']:.3f} "
            "ms as split TF32")
        _flash_f64_precision(kfa, q, k, v, out, lse, do, tag)
        _flash_fwd_f64_precision(kfa, q, k, v, tag)
        q2, k2, v2 = _qkv_views(randn, 2, 200, 4, 64)
        _flash_fwd_f64_precision(kfa, q2, k2, v2, "B2 S200 H4 D64 causal")
    del q, k, v, do, out, lse, ql, kl, vl, lib_out
    torch.cuda.empty_cache()
    return results


def _flash_f64_precision(kfa, q, k, v, out, lse, do, tag):
    """The split-TF32 and the SIMT backward's largest errors against dq,
    dk and dv in float64 (einsum on ``.double()`` copies of the same
    inputs, the kernel's own out and lse among them; causal); fails if
    the split-TF32 one passes FLASH_F64_FACTOR times the SIMT one."""
    import torch

    b, s, h, d = q.shape
    new = kfa.flash_attention_bwd(q, k, v, out, lse, do, True)
    old = kfa._launch_bwd(q, k, v, out, lse, do, True, None, None, simt=True)
    qd, kd, vd, od, dod = (t.double() for t in (q, k, v, out, do))
    scale = d ** -0.5
    sc = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale
    keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.exp(sc.masked_fill(~keep, float("-inf"))
                  - lse.double().reshape(b, h, s)[..., None])
    del sc
    delta = (dod * od).sum(-1).permute(0, 2, 1)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dod, vd)
              - delta[..., None]) * scale
    exact = (torch.einsum("bhqk,bkhd->bqhd", ds, kd),
             torch.einsum("bhqk,bqhd->bkhd", ds, qd),
             torch.einsum("bhqk,bqhd->bkhd", p, dod))
    del p, ds
    parts = []
    for name, a, o, x in zip(("dq", "dk", "dv"), new, old, exact):
        e_new = float((a.double() - x).abs().max())
        e_old = float((o.double() - x).abs().max())
        parts.append(f"{name} {e_new:.3e} vs {e_old:.3e} "
                     f"({e_new / e_old:.2f}x; max|grad| "
                     f"{float(x.abs().max()):.3e})")
        if not e_new <= FLASH_F64_FACTOR * e_old:
            fail(f"flash {name} {tag}: split-TF32 error {e_new:.3e} against "
                 f"float64 passes {FLASH_F64_FACTOR}x the SIMT kernel's "
                 f"{e_old:.3e}")
    log(f"  against a float64 backward at {tag}, largest error split-TF32 "
        "vs SIMT: " + "; ".join(parts))
    del new, old, exact
    torch.cuda.empty_cache()


def _flash_fwd_f64_precision(kfa, q, k, v, tag):
    """The split-TF32 and the SIMT forward's largest errors against out in
    float64 (a softmax of ``.double()`` scores; causal); fails if the
    split-TF32 one passes FLASH_F64_FACTOR times the SIMT one."""
    import torch

    b, s, h, d = q.shape
    new, _ = kfa._launch_fwd(q, k, v, True, None)
    old, _ = kfa._launch_fwd(q, k, v, True, None, simt=True)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * d ** -0.5
    keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(sc.masked_fill(~keep, float("-inf")), -1)
    del sc
    exact = torch.einsum("bhqk,bkhd->bqhd", p, v.double())
    del p
    e_new = float((new.double() - exact).abs().max())
    e_old = float((old.double() - exact).abs().max())
    log(f"  against a float64 forward at {tag}, largest error split-TF32 "
        f"{e_new:.3e} vs SIMT {e_old:.3e} ({e_new / e_old:.2f}x; max|out| "
        f"{float(exact.abs().max()):.3e})")
    if not e_new <= FLASH_F64_FACTOR * e_old:
        fail(f"flash fwd {tag}: split-TF32 error {e_new:.3e} against float64 "
             f"passes {FLASH_F64_FACTOR}x the SIMT kernel's {e_old:.3e}")
    del new, old, exact
    torch.cuda.empty_cache()


def _gemm_f64_precision(what, new, simt, exact):
    """The split-TF32 engine's and the SIMT tile's largest errors against
    a float64 result ``exact`` of the same inputs; fails if the first
    passes GEMM_F64_FACTOR times the second.  Returns the ratio."""
    e_new = float((new.double() - exact).abs().max())
    e_old = float((simt.double() - exact).abs().max())
    log(f"    against float64 at {what}: split TF32 {e_new:.3e}, SIMT "
        f"{e_old:.3e} ({e_new / e_old:.2f}x; max|exact| "
        f"{float(exact.abs().max()):.3e})")
    if not e_new <= GEMM_F64_FACTOR * e_old:
        fail(f"{what}: split-TF32 error {e_new:.3e} against float64 passes "
             f"{GEMM_F64_FACTOR}x the SIMT tile's {e_old:.3e}")
    return e_new / e_old


def _conv_f64(x, w, p):
    """The SAME conv of x (N, H, W, C) and w (KH, KW, C, O) in float64:
    the shifted products of the padded image."""
    import torch.nn.functional as F

    n, h, wd, _ = x.shape
    xp = F.pad(x.double(), (0, 0, p, p, p, p))
    out = 0
    for i in range(w.shape[0]):
        for j in range(w.shape[1]):
            out = out + xp[:, i:i + h, j:j + wd, :] @ w[i, j].double()
    return out


def _dw_f64(x, g, k, p):
    """The filter gradient of x (N, H, W, C) and g (N, H, W, O) in float64:
    each tap's shifted padded image times g."""
    import torch
    import torch.nn.functional as F

    n, h, wd, c = x.shape
    xp = F.pad(x.double(), (0, 0, p, p, p, p))
    gd = g.double().reshape(-1, g.shape[3])
    out = torch.empty(k, k, c, g.shape[3], dtype=torch.float64,
                      device=x.device)
    for i in range(k):
        for j in range(k):
            out[i, j] = xp[:, i:i + h, j:j + wd, :].reshape(-1, c).t() @ gd
    return out


def _library_kernels(fn):
    """[(kernel name, launches)] of the CUDA kernels one profiled call of
    ``fn`` ran, after one unprofiled call (``cuda_window``)."""
    import torch

    fn()
    torch.cuda.synchronize()
    return [(e.key[:90], e.count) for e in cuda_window(fn)]


def _time_bwd_launches(kfa, dq_name, dkv_name, run, reps=10):
    """Median ms of the dq launch and of the dk/dv launch of one backward
    call ``run()``, each bracketed by CUDA events on the current stream
    around the library's entries ``dq_name`` and ``dkv_name``."""
    import torch

    lib = kfa._build.load("flash_attention", kfa._SIGNATURES)
    marks = []
    real = {n: getattr(lib, n) for n in (dq_name, dkv_name)}

    def timed_entry(fn):
        def call(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            err = fn(*args)
            end.record()
            marks.append((start, end))
            return err
        return call

    for n, fn in real.items():
        setattr(lib, n, timed_entry(fn))
    try:
        for _ in range(2):
            run()
        torch.cuda.synchronize()
        marks.clear()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    finally:
        for n, fn in real.items():
            setattr(lib, n, fn)
    dq = [a.elapsed_time(b) for a, b in marks[0::2]]
    dkv = [a.elapsed_time(b) for a, b in marks[1::2]]
    return statistics.median(dq), statistics.median(dkv)


def transformer_matmul_shapes():
    """{(m, k, n): launches per step} of the matmul kernel in the
    transformer step: qkv, proj, ffn1, ffn2 per layer, and lm_head."""
    m = TF_BATCH * TF_SEQ
    d, layers = TF_CONFIG["d_model"], TF_CONFIG["num_layers"]
    f = d * TF_CONFIG["ffn_mult"]
    return {(m, d, 3 * d): layers, (m, d, d): layers, (m, d, f): layers,
            (m, f, d): layers, (m, d, TF_CONFIG["vocab_size"]): 1}


def phase_tf_matmul(dev, randn, bf16=False):
    """The matmul kernel (its bf16 instance with ``bf16``) against its
    plain version at every shape of the transformer step, summed over the
    step's 17 launches (torch.matmul the library call, TF32 off; bound at
    67 TFLOP/s f32 or 989 bf16)."""
    import torch

    from paddle_tpu_torch.kernels import matmul as kmatmul

    dt = torch.bfloat16 if bf16 else torch.float32
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
    sm = _Sum(peak)
    tile_ms = 0.0
    bound_tf32 = 0.0
    log(f"{dt} matmul at the transformer step's shapes (B*S = "
        f"{TF_BATCH * TF_SEQ}), per call:")
    for (m, k, n), count in transformer_matmul_shapes().items():
        x = randn(m, k).to(dt)
        y = randn(k, n, scale=k ** -0.5).to(dt)
        got, want = kmatmul.matmul(x, y), kmatmul.matmul_plain(x, y)
        err = (check_bf16(f"bf16 matmul {m}x{k}x{n}", got, want) if bf16
               else check_close(f"matmul {m}x{k}x{n}", got, want, **GEMM_TOL))
        times = (time_ms(lambda: kmatmul.matmul(x, y), reps=5),
                 time_ms(lambda: kmatmul.matmul_plain(x, y), reps=5),
                 time_ms(lambda: torch.matmul(x, y), reps=5))
        flops = 2.0 * m * k * n
        nbytes = x.element_size() * (m * k + k * n + m * n)
        _line(f"{m}x{k}x{n}", count, *times, flops, nbytes, err, peak)
        sm.add(count, *times, flops, nbytes, err)
        if bf16:
            tile_ms += count * _old_tile(
                f"bf16 matmul {m}x{k}x{n}", want, times[0], flops,
                lambda: kmatmul._launch(x, y, "mma.sync"),
                kmatmul.bf16_engine(m, k, n, x.data_ptr(), y.data_ptr()))
        else:
            # the SIMT tile the split-TF32 engine replaced, and both held
            # to a float64 product over the step's K at fewer rows
            engine = kmatmul.f32_engine(m, k, n, x.data_ptr(), y.data_ptr())
            tile_ms += count * _old_tile(
                f"matmul {m}x{k}x{n}", want, times[0], flops,
                lambda: kmatmul._launch(x, y, "simt"), engine,
                lambda name, got, want: check_close(name, got, want,
                                                    **GEMM_TOL), "SIMT")
            bound_tf32 += count * 3 * flops / PEAK_TF32_FLOPS * 1e3
            xr = x[:GEMM_F64_ROWS]
            _gemm_f64_precision(
                f"matmul {GEMM_F64_ROWS}x{k}x{n}",
                kmatmul._launch(xr, y, "wgmma"), kmatmul._launch(xr, y, "simt"),
                xr.double() @ y.double())
        del x, y, got, want
    torch.cuda.empty_cache()
    r = sm.result()
    log(f"  one transformer step's {dt} matmul launches: kernel "
        f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, library "
        f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
        f"({r['bound_by']}); max err {r['max_abs_err']:.2e}"
        + (f"; the mma.sync tile {tile_ms:.3f} ms" if bf16 else
           f"; the SIMT tile {tile_ms:.3f} ms, bound {bound_tf32:.3f} ms as "
           "split TF32"))
    r["mma_sync_ms" if bf16 else "simt_ms"] = tile_ms
    if not bf16:
        r["bound_tf32_ms"] = bound_tf32
    return r


def mul_shapes_of(program, batch):
    """{(m, k, n): count} of the matmul kernel's launches in one run of
    ``program`` (one per ``mul`` op), ``batch`` in every -1 dim."""
    block = program.global_block()
    shapes = {}
    for op in block.ops:
        if op.type != "mul":
            continue
        x = [batch if d < 0 else d for d in block.var(op.input("X")[0]).shape]
        y = block.var(op.input("Y")[0]).shape
        xc, yc = op.attr("x_num_col_dims", 1), op.attr("y_num_col_dims", 1)
        key = (math.prod(x[:xc]), math.prod(x[xc:]), math.prod(y[yc:]))
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def phase_seq_dense(dev, randn):
    """The matmul and softmax kernels against their plain versions at the
    sequence steps' own shapes: the padded classifier's three products at
    B 64, T 100 (from its program), in f32 and in bf16 (its AMP step, each
    on the engine the rule picks), and its 64 x 2 softmax; the LoD
    classifier's two products at the step's 3,435 rows and 64 sequences.
    Logged; the kernels line keeps the transformer's and ResNet's."""
    import torch

    from paddle_tpu_torch.kernels import matmul as kmatmul
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    rows = lod_feed(np.random.RandomState(8))["ids"][1][0][-1]
    paths = {
        f"LSTM classifier step, B {LSTM_BATCH} T {LSTM_SEQ}": mul_shapes_of(
            build_lstm_program()[0], LSTM_BATCH),
        f"LoD classifier step, {rows} rows": {(rows, LSTM_EMB, LOD_FC): 1,
                                               (LOD_SEQS, LOD_FC, 2): 1},
    }
    for what, shapes in paths.items():
        sm = _Sum()
        log(f"matmul at the {what}'s shapes, per call:")
        for (m, k, n), count in shapes.items():
            x = randn(m, k)
            y = randn(k, n, scale=k ** -0.5)
            err = check_close(f"matmul {m}x{k}x{n}", kmatmul.matmul(x, y),
                              kmatmul.matmul_plain(x, y), **GEMM_TOL)
            times = (time_ms(lambda: kmatmul.matmul(x, y)),
                     time_ms(lambda: kmatmul.matmul_plain(x, y)),
                     time_ms(lambda: torch.matmul(x, y)))
            flops, nbytes = 2.0 * m * k * n, 4.0 * (m * k + k * n + m * n)
            _line(f"{m}x{k}x{n}", count, *times, flops, nbytes, err)
            sm.add(count, *times, flops, nbytes, err)
        r = sm.result()
        log(f"  the {what}'s matmul launches: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}); max err "
            f"{r['max_abs_err']:.2e} (tolerance {GEMM_TOL})")
    # the classifier's AMP step multiplies the same shapes in bf16, on the
    # engine the rule picks for each
    bf = torch.bfloat16
    sm = _Sum(PEAK_BF16_FLOPS)
    log("bf16 matmul at the LSTM classifier's AMP step's shapes, per call:")
    for (m, k, n), count in paths[next(iter(paths))].items():
        x = randn(m, k).to(bf)
        y = randn(k, n, scale=k ** -0.5).to(bf)
        engine = kmatmul.bf16_engine(m, k, n, x.data_ptr(), y.data_ptr())
        err = check_bf16(f"bf16 matmul {m}x{k}x{n}", kmatmul.matmul(x, y),
                         kmatmul.matmul_plain(x, y))
        times = (time_ms(lambda: kmatmul.matmul(x, y)),
                 time_ms(lambda: kmatmul.matmul_plain(x, y)),
                 time_ms(lambda: torch.matmul(x, y)))
        flops, nbytes = 2.0 * m * k * n, 2.0 * (m * k + k * n + m * n)
        _line(f"{m}x{k}x{n} ({engine} engine)", count, *times, flops, nbytes,
              err, PEAK_BF16_FLOPS)
        sm.add(count, *times, flops, nbytes, err)
    r = sm.result()
    log(f"  the LSTM classifier's AMP step's matmul launches: kernel "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
        f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}); max err {r['max_abs_err']:.2e}")
    x = randn(LSTM_BATCH, 2, scale=4.0)   # both steps' head: 64 rows, 2 classes
    err = check_close(f"softmax {LSTM_BATCH}x2", ksoftmax.softmax(x),
                      ksoftmax.softmax_plain(x), rtol=0, atol=SOFTMAX_ATOL)
    times = (time_ms(lambda: ksoftmax.softmax(x)),
             time_ms(lambda: ksoftmax.softmax_plain(x)),
             time_ms(lambda: torch.softmax(x, dim=-1)))
    _line(f"softmax {LSTM_BATCH}x2", 1, *times, 5.0 * x.numel(),
          8.0 * x.numel(), err)
    log(f"  (tolerance atol {SOFTMAX_ATOL})")


def phase_kernels(dev, serve_shapes, train_conv_shapes, train_bn_shapes):
    """Every kernel against its plain version.  The kernels line keeps the
    matmul's numbers at the transformer step's shapes, f32 and bf16 (its
    17 launches there; the ResNet and sequence shapes are logged)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    results = phase_conv_kernels(dev, serve_shapes, train_conv_shapes, randn)
    results.update(phase_bn_instance(torch.float32, train_bn_shapes, randn))
    results.update(phase_dense_kernels(dev, randn))
    results.update(phase_bf16_kernels(dev, train_conv_shapes,
                                      train_bn_shapes, randn))
    results.update(phase_flash_kernels(dev, randn))
    results.update(phase_flash_kernels(dev, randn, bf16=True))
    results["matmul"] = phase_tf_matmul(dev, randn)
    results["matmul_bf16"] = phase_tf_matmul(dev, randn, bf16=True)
    phase_seq_dense(dev, randn)
    phase_wide_deep_dense(dev, randn)
    phase_seq2seq_dense(dev, randn)
    results.update(phase_lstm_kernels(dev, randn))
    results.update(phase_lstm_bf16_kernel(dev, randn))
    results["embedding"] = phase_gather_kernel(dev, randn)
    results.update(phase_paged_kernels(dev, randn))
    for name, us in phase_wrapper_host(dev, randn).items():
        results[name]["host_us"] = us
    return results


def phase_wrapper_host(dev, randn):
    """The host's microseconds a call (``host_us``) of the conv, matmul,
    flash forward and LSTM wrappers, at the shapes
    scripts/launch_host_cost.py times them (the BN, softmax, gather and
    paged wrappers' are taken in their own phases)."""
    import torch

    from paddle_tpu_torch.kernels import conv as kconv
    from paddle_tpu_torch.kernels import flash_attention as kfa
    from paddle_tpu_torch.kernels import lstm as klstm
    from paddle_tpu_torch.kernels import matmul as kmatmul

    cx, cw = randn(2, 7, 7, 512), randn(3, 3, 512, 512, scale=0.02)
    mx, my = randn(256, 2048), randn(2048, 1000, scale=0.03)
    q, k, v = (randn(1, 128, 16, 128) for _ in range(3))
    xp, lw = randn(64, 100, 1024), randn(256, 1024, scale=0.05)
    lb, h0 = randn(1024), torch.zeros(64, 256, device=dev)
    out = {"conv2d_nhwc": host_us(lambda: kconv.conv2d_nhwc(cx, cw, 1)),
           "matmul": host_us(lambda: kmatmul.matmul(mx, my)),
           "flash_attention_fwd": host_us(
               lambda: kfa.flash_attention_fwd(q, k, v)),
           "lstm": host_us(lambda: klstm.lstm_seq(xp, lw, lb, h0, h0))}
    log("wrappers' host us a call: " + ", ".join(
        f"{n} {us:.2f}" for n, us in out.items()))
    return out


# ---------------------------------------------------------------------------
# phase 3: serving
# ---------------------------------------------------------------------------


def calibrate_bn(program, scope, feed, dev, seed):
    """Overwrite every batch_norm's running mean and variance in
    ``scope`` with seeded values near the statistics of ``feed``: the
    mean with jitter, the "variance" the second moment about zero
    floored at its layer's median, times a seeded factor in [0.8, 1.25].
    A randomly initialised ResNet-50 then neither saturates its softmax
    nor amplifies float32 rounding through near-zero variances, and BN
    is not the identity.  Runs the port's op rules one after another on
    ``dev``; returns the new values as {name: float32 array}."""
    import torch

    from paddle_tpu_torch.registry import LowerContext, OpRegistry

    rng = np.random.RandomState(seed)
    values = {n: scope.get(n) for n in scope.keys()}
    values.update({k: torch.as_tensor(v, device=dev) for k, v in feed.items()})
    stats = {}
    with torch.no_grad():
        for op in program.global_block().ops:
            if op.type == "batch_norm":
                x = values[op.input("X")[0]].double()
                mean = x.mean((0, 2, 3)).cpu().numpy()
                second = (x * x).mean((0, 2, 3)).cpu().numpy()
                mean = mean + 0.1 * np.sqrt(second) * rng.randn(mean.size)
                var = (np.maximum(second, np.median(second))
                       * rng.uniform(0.8, 1.25, second.size))
                for slot, arr in (("Mean", mean), ("Variance", var)):
                    name = op.input(slot)[0]
                    stats[name] = arr.astype(np.float32)
                    values[name] = torch.as_tensor(stats[name], device=dev)
                    scope.set(name, values[name])
            OpRegistry.get(op.type).lower(LowerContext(op, values, dev))
    return stats


def post(base, images, timeout=600):
    req = urllib.request.Request(
        f"{base}/predict", data=json.dumps({"img": images.tolist()}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def phase_serving(dev, model_dir, rng):
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.serving import InferenceServer, ModelBundle, Replica

    t0 = time.perf_counter()
    srv = InferenceServer(model_dir, max_batch=SERVE_BATCH, warmup=True)
    log(f"server up on {srv.address} ({srv.place!r}), bucket ladder "
        f"{srv.batching_info()['buckets']} warmed in "
        f"{time.perf_counter() - t0:.1f} s")
    try:
        if srv.place != pt.CUDAPlace(0):
            fail(f"InferenceServer defaulted to {srv.place!r}")
        forwards = []
        for rep in srv._pool.replicas:
            run = rep.run

            def counted(feeds, run=run):
                forwards.append(len(next(iter(feeds.values()))))
                return run(feeds)

            rep.run = counted
        with urllib.request.urlopen(f"http://{srv.address}/health",
                                    timeout=30) as r:
            health = json.loads(r.read())
        if health["status"] != "ok" or health["feeds"] != ["img"]:
            fail(f"/health says {health}")
        log(f"/health: {health}")

        requests = [rng.randn(n, 3, 224, 224).astype(np.float32)
                    for n in REQUEST_SIZES]
        replies = [None] * len(requests)
        errors = []

        def client(i):
            try:
                replies[i] = post(f"http://{srv.address}", requests[i])
            except Exception as exc:  # reported below, fails the phase
                errors.append(f"request {i}: {exc!r}")

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(requests))]
        torch.cuda.synchronize()
        zero_counters()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = counters()
        wgmma = wgmma_counters()
        if errors or any(t.is_alive() for t in threads):
            fail(f"requests failed: {errors or 'timed out'}")
    finally:
        srv.stop()
    batches = len(forwards)
    log(f"{len(requests)} concurrent requests ({sum(REQUEST_SIZES)} images) "
        f"served in {wall:.2f} s wall (JSON on the host included) as "
        f"{batches} forward batches of {forwards} rows; launches {launches}")
    want = dict.fromkeys(KERNELS, 0)
    want.update(conv2d_nhwc=46 * batches, matmul=batches, softmax=batches)
    if launches != want:
        fail(f"launch counts {launches} != {want} for {batches} forwards")
    # every conv launch on the split-TF32 wgmma engine, the fc on the SIMT
    # tile (at most 32 rows)
    want = dict.fromkeys(wgmma, 0)
    want.update(conv2d_nhwc=46 * batches)
    if wgmma != want:
        fail(f"wgmma launch counts {wgmma} != {want} for {batches} forwards")
    log(f"on the wgmma engine: {wgmma}")

    # the same export on the CPU, through the kernels' plain versions
    ref = Replica(ModelBundle(model_dir), 0, pt.CPUPlace())
    worst = 0.0
    for i, (images, reply) in enumerate(zip(requests, replies)):
        got = np.asarray(reply["outputs"][0], np.float32)
        (cpu,) = ref.run({"img": images})
        if got.shape != (len(images), 1000) or not np.isfinite(got).all():
            fail(f"request {i}: reply shape {got.shape} or non-finite values")
        err = float(np.abs(got - cpu).max())
        worst = max(worst, err)
        if not np.allclose(got, cpu, **PROBS_TOL):
            fail(f"request {i}: card vs CPU probabilities differ by {err:.3e}"
                 f" (tolerance {PROBS_TOL})")
        if not (got.argmax(1) == cpu.argmax(1)).all():
            fail(f"request {i}: argmax differs: {got.argmax(1)} vs "
                 f"{cpu.argmax(1)}")
    log(f"replies match the CPU plain path: max abs err {worst:.3e} "
        f"(tolerance {PROBS_TOL}), argmax equal; max prob "
        f"{max(float(np.max(r['outputs'][0])) for r in replies):.4f}")
    return launches, wgmma


def post_as(base, images, tenant, via="header", timeout=600):
    """(status, reply) of one POST /predict of ``images`` as ``tenant``,
    named by the X-Tenant header or by the "tenant" key."""
    payload = {"img": images.tolist()}
    headers = {"Content-Type": "application/json"}
    if via == "header":
        headers["X-Tenant"] = tenant
    else:
        payload["tenant"] = tenant
    req = urllib.request.Request(f"{base}/predict",
                                 data=json.dumps(payload).encode(),
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get_json(base, path, timeout=60):
    with urllib.request.urlopen(f"{base}{path}", timeout=timeout) as r:
        return json.loads(r.read())


_PROM_SAMPLE = re.compile(r"([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)")
_PROM_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text):
    """{(name, ((label, value), ...)): value} of a Prometheus 0.0.4 text
    scrape.  ValueError on a line that is neither a HELP or TYPE comment
    nor a sample of a family a TYPE line declared before it."""
    kinds, samples = {}, {}
    for line in text.splitlines():
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            if kind not in ("counter", "gauge", "histogram", "summary",
                            "untyped"):
                raise ValueError(f"unknown metric type: {line!r}")
            kinds[name] = kind
            continue
        m = _PROM_SAMPLE.fullmatch(line)
        if m is None:
            raise ValueError(f"not a Prometheus sample: {line!r}")
        name, body, value = m.groups()
        family = name
        for suffix in ("_bucket", "_sum", "_count"):
            stem = name[:-len(suffix)]
            if name.endswith(suffix) and kinds.get(stem) == "histogram":
                family = stem
        if family not in kinds:
            raise ValueError(f"sample of an undeclared family: {line!r}")
        labels = ()
        if body:
            pairs = _PROM_LABEL.findall(body[1:-1])
            if ",".join(f'{k}="{v}"' for k, v in pairs) != body[1:-1]:
                raise ValueError(f"malformed labels: {line!r}")
            labels = tuple(sorted(
                (k, re.sub(r"\\(.)", lambda c: "\n" if c.group(1) == "n"
                           else c.group(1), v)) for k, v in pairs))
        samples[(name, labels)] = float(value)
    return samples


def prom_total(samples, name, **labels):
    """The sum of ``name``'s samples whose labels include ``labels``."""
    want = {(k, str(v)) for k, v in labels.items()}
    return sum(v for (n, ls), v in samples.items()
               if n == name and want <= set(ls))


def phase_serving_ops(dev, model_dir, rng):
    import gc
    import weakref

    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.flags import FLAGS
    from paddle_tpu_torch.serving import (FaultInjector, InferenceServer,
                                          ModelBundle, Replica,
                                          bucket_ladder, next_bucket)

    t_phase = time.perf_counter()
    overhead_us = obs.measure_step_overhead() * 1e6
    log(f"telemetry writes of one cached Executor.run on this host: "
        f"{overhead_us:.2f} us (measure_step_overhead)")
    obs.reset()
    ladder = bucket_ladder(SERVE_BATCH)
    t0 = time.perf_counter()
    srv = InferenceServer(model_dir, replicas=2, max_batch=SERVE_BATCH,
                          warmup=True, tenants=OPS_TENANTS, chaos="die@2",
                          dispatch_timeout=OPS_DISPATCH_TIMEOUT)
    base = f"http://{srv.address}"
    pool = srv._pool
    log(f"two replicas up on {srv.place!r}, ladder {list(ladder)} warmed in "
        f"{time.perf_counter() - t0:.1f} s")
    replies, health_log, health_at, poll_errors = [], [], [], []
    stop_polling = threading.Event()
    poller = None
    try:
        places = [rep.exe.place for rep in pool.replicas]
        if places != [pt.CUDAPlace(0)] * 2:
            fail(f"the replicas sit on {places}, not CUDAPlace(0)")
        if not srv.fault._armed:
            fail("the --chaos spec was not armed after warmup")
        # both sources: plans captured on their second run (graph) and
        # plans that run eagerly (plan)
        misses = prom_total(parse_prometheus(obs.render_prometheus()),
                            "executor_compile_cache_miss_total")
        if misses != 2 * len(ladder):
            fail(f"{misses} plan-cache misses after warming two replicas, "
                 f"not {2 * len(ladder)}")
        param_bytes = sum(t.numel() * t.element_size()
                          for t in pool.replicas[0].scope.values.values())
        gc.collect()
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        # the tensors the live replicas' CUDA graphs keep (static feeds,
        # fetches): a graph's, not a leak; a dead replica's go with it
        graphs_before = sum(rep.exe.graph_stats()["static_bytes"]
                            for rep in pool.replicas)
        # each replica's Executor, held weakly: a dead replica's must be
        # freed, and with it its plans and CUDA graphs (their pools are
        # reserved memory, which memory_allocated does not count)
        executors = {rep.index: weakref.ref(rep.exe) for rep in pool.replicas}
        pools_before = graph_pools()

        def poll():
            while not stop_polling.is_set():
                try:
                    h = get_json(base, "/health")
                    health_log.append((h["status"], tuple(h["reasons"])))
                    health_at.append(time.perf_counter())
                except Exception as exc:  # reported below, fails the phase
                    poll_errors.append(repr(exc))
                stop_polling.wait(0.01)

        def send(images, tenant, via):
            code, body = post_as(base, images, tenant, via)
            replies.append((images, tenant, code, body))

        zero_counters()
        # dispatch 1, alone; then the burst, whose first dispatch dies
        send(rng.randn(2, 3, 224, 224).astype(np.float32), "gold", "header")
        poller = threading.Thread(target=poll, daemon=True)
        poller.start()
        jobs = [(rng.randn(n, 3, 224, 224).astype(np.float32), "gold",
                 ("header", "key")[i % 2])
                for i, n in enumerate(OPS_GOLD_SIZES)]
        jobs += [(rng.randn(1, 3, 224, 224).astype(np.float32), "bronze",
                  ("key", "header")[i % 2])
                 for i in range(OPS_BRONZE_REQUESTS)]
        threads = [threading.Thread(target=send, args=job) for job in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            fail("a request of the burst did not return")
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and (
                len(pool.replicas) != 2 or srv.degraded_reasons()):
            time.sleep(0.05)
        time.sleep(0.2)     # the poller reads the healed state
        stop_polling.set()
        poller.join(timeout=60)
        if poll_errors or poller.is_alive():
            fail(f"/health polls failed: {poll_errors[:3]}")
        if srv.fault.fired != 1:
            fail(f"die@2 fired {srv.fault.fired} times, not once")
        seen = [s for s in health_log if s[0] == "degraded"]
        if not seen or ("degraded", ("replicas_down:1",)) not in seen:
            fail(f"/health never said degraded with replicas_down:1 while "
                 f"a replica was down: {sorted(set(health_log))}")
        if health_log[-1] != ("ok", ()):
            fail(f"/health says {health_log[-1]} after the respawn")
        down = [t for t, h in zip(health_at, health_log)
                if h[0] == "degraded"]
        log(f"/health over the death: {len(health_log)} polls, "
            f"{len(seen)} degraded {sorted(set(seen))} over "
            f"{down[-1] - down[0]:.3f} s, then ok")
        places = [rep.exe.place for rep in pool.replicas]
        if places != [pt.CUDAPlace(0)] * 2:
            fail(f"the respawned replicas sit on {places}")

        # one more bronze request, alone: refused before any launch
        before = counters()
        images = rng.randn(1, 3, 224, 224).astype(np.float32)
        code, body = post_as(base, images, "bronze", "key")
        replies.append((images, "bronze", code, body))
        if (code, body.get("reason")) != (429, "tenant_over_quota"):
            fail(f"the over-quota request got {code} {body}")
        if counters() != before:
            fail("an over-quota request moved the launch counters")

        # a hang on the surviving original replica, past the lease
        plans = {rep.index: len(rep.exe._cache) for rep in pool.replicas}
        originals = [i for i in plans if i < 2]
        if len(originals) != 1:
            fail(f"live replicas {sorted(plans)} after one death")
        hung = originals[0]
        hang = FaultInjector("hang", replica=hung, hang_s=OPS_HANG_S)
        pool.fault = hang
        # no name of this frame may keep a replica (and its parameters)
        # alive past its death
        list(map(lambda r: setattr(r, "fault", hang), pool.replicas))
        hang.arm()
        for _ in range(20):
            images = rng.randn(OPS_HANG_ROWS, 3, 224, 224).astype(np.float32)
            t0 = time.perf_counter()
            send(images, "gold", "header")
            if hang.fired:
                break
        waited = time.perf_counter() - t0
        if hang.fired != 1:
            fail("the hang never fired on its replica")
        if replies[-1][2] != 200 or not waited < OPS_HANG_S:
            fail(f"the hung request got {replies[-1][2]} after "
                 f"{waited:.2f} s (hang {OPS_HANG_S} s)")
        log(f"replica {hung} hung: its request answered by another "
            f"replica after {waited:.2f} s (lease {OPS_DISPATCH_TIMEOUT} "
            f"s, hang {OPS_HANG_S} s)")
        with pool._lock:
            zombie = pool._threads[hung]
        zombie.join(timeout=OPS_HANG_S + 120)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and (
                len(pool.replicas) != 2 or srv.degraded_reasons()):
            time.sleep(0.05)
        if zombie.is_alive() or srv.degraded_reasons():
            fail(f"after the hang: zombie alive {zombie.is_alive()}, "
                 f"/health reasons {srv.degraded_reasons()}")
        launches = counters()
        wgmma = wgmma_counters()
        # every replica's plans: the one that died at dispatch 2 had only
        # its ladder, the hung one what it had before it hung (its late
        # batch is a ladder shape), the live ones what they hold now
        plans_end = {rep.index: len(rep.exe._cache)
                     for rep in pool.replicas}
        want_misses = len(ladder) + plans[hung] + sum(plans_end.values())
        gc.collect()
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        graphs_after = sum(rep.exe.graph_stats()["static_bytes"]
                           for rep in pool.replicas)
        live_graphs = sum(rep.exe.graph_stats()["graphs"]
                          for rep in pool.replicas)
        live = {rep.index for rep in pool.replicas}
        kept = sorted(i for i, ref in executors.items()
                      if i not in live and ref() is not None)
        dead = sorted(set(executors) - live)
        pools_after = graph_pools()
        log(f"device memory: {mem_before / 2**20:.1f} MiB before the first "
            f"death ({graphs_before / 2**20:.1f} MiB in the replicas' "
            f"graphs), {mem_after / 2**20:.1f} MiB after both respawns "
            f"({graphs_after / 2**20:.1f} MiB in the live replicas' "
            f"{live_graphs} graphs; one replica's parameters "
            f"{param_bytes / 2**20:.1f} MiB); graph pools in the process "
            f"{pools_before[0]} ({pools_before[1] / 2**20:.1f} MiB) before, "
            f"{pools_after[0]} ({pools_after[1] / 2**20:.1f} MiB) after; "
            f"the Executors of the dead replicas {dead} freed: "
            f"{[i for i in dead if i not in kept]}")
        if not dead or kept:
            fail(f"dead replicas {dead}: the Executors of {kept} (their "
                 "plans and CUDA graphs) were not freed")
        # the sound runs read within 2 MiB; one leaked scope adds a whole
        # param_bytes, so a quarter of it lies between the two
        grew = (mem_after - graphs_after) - (mem_before - graphs_before)
        if abs(grew) > param_bytes / 4:
            fail(f"a dead replica's scope was not freed: "
                 f"{grew / 2**20:+.1f} MiB, more than a quarter of one "
                 f"replica's parameters")

        with urllib.request.urlopen(f"{base}/metrics", timeout=60) as r:
            ctype = r.headers["Content-Type"]
            samples = parse_prometheus(r.read().decode())
        stats = get_json(base, "/stats")
        snap = json.loads(json.dumps(obs.snapshot()))
        trace = obs.export_chrome_trace(os.path.join(
            tempfile.mkdtemp(dir=os.path.dirname(model_dir)), "host.json"))
    finally:
        stop_polling.set()
        srv.stop()
    if ctype != "text/plain; version=0.0.4; charset=utf-8":
        fail(f"/metrics content type {ctype!r}")

    codes = [c for _, _, c, _ in replies]
    n200, n429 = codes.count(200), codes.count(429)
    bronze_ok = sum(1 for _, t, c, _ in replies if t == "bronze" and c == 200)
    if n200 + n429 != len(replies) or bronze_ok != OPS_BRONZE_BURST:
        fail(f"replies {codes}: bronze admitted {bronze_ok}, not "
             f"{OPS_BRONZE_BURST}")
    if any(t == "gold" and c != 200 for _, t, c, _ in replies):
        fail(f"a gold request was refused: {codes}")
    # serving_batch_size counts every dispatch, the one that died at its
    # start (before any launch) too; the requeued requests ran solo, the
    # hung one's among them, so the dead batch held the solo rows but the
    # hung request's
    rows_by = {ls: v for (n, ls), v in samples.items()
               if n == "serving_batch_size_count"}
    forwards = int(sum(rows_by.values())) - 1
    solo_rows = prom_total(samples, "serving_batch_size_sum",
                           bucket="unbatched")
    dispatched = solo_rows + sum(
        v * int(dict(ls)["bucket"]) for ls, v in rows_by.items()
        if dict(ls)["bucket"] != "unbatched")
    dispatched -= next_bucket(int(solo_rows) - OPS_HANG_ROWS)
    requeued = prom_total(samples, "serving_requeued_total")
    checks = {
        "deaths injected": (prom_total(samples,
                                       "serving_replica_deaths_total",
                                       cause="injected"), 1),
        "deaths hang": (prom_total(samples, "serving_replica_deaths_total",
                                   cause="hang"), 1),
        "deaths in all": (prom_total(samples,
                                     "serving_replica_deaths_total"), 2),
        "restarts": (prom_total(samples, "serving_replica_restarts_total"),
                     2),
        # each requeued request redispatched once, solo
        "requeued, redispatched": (prom_total(
            samples, "serving_unbatched_total", reason="requeued"),
            requeued),
        "responses 200": (prom_total(samples, "serving_responses_total",
                                     code="200"),
                          n200 + len(health_log)),
        "responses 429": (prom_total(samples, "serving_responses_total",
                                     code="429"), n429),
        "rejected bronze": (prom_total(samples, "serving_rejected_total",
                                       reason="tenant_over_quota",
                                       tenant="bronze"), n429),
        "plan-cache misses": (prom_total(
            samples, "executor_compile_cache_miss_total"), want_misses),
        "fetched bytes": (prom_total(
            samples, "executor_fetch_device_to_host_bytes_total"),
            4000 * (2 * sum(ladder) + dispatched)),
        "conv launches": (launches["conv2d_nhwc"], 46 * forwards),
        "conv launches on wgmma": (wgmma["conv2d_nhwc"], 46 * forwards),
        "matmul launches": (launches["matmul"], forwards),
        "softmax launches": (launches["softmax"], forwards),
    }
    bad = {k: v for k, v in checks.items() if v[0] != v[1]}
    if bad or requeued < 2:
        fail(f"/metrics or the counters disagree with the phase (got, "
             f"want): {bad}; requeued {requeued}")
    others = {k: v for k, v in launches.items()
              if v and k not in ("conv2d_nhwc", "matmul", "softmax")}
    if others:
        fail(f"unexpected launches on the serving path: {others}")
    log(f"/metrics agrees: {forwards} forwards, {requeued:g} requeued, "
        + ", ".join(f"{k} {v[0]:g}" for k, v in checks.items()))
    # /stats is the snapshot the scrape rendered; the /stats reply itself
    # counts one more 200 after its snapshot was taken
    resp = snap.pop("serving_responses_total")
    stats_resp = stats.pop("serving_responses_total")
    for v in resp["values"]:
        if v["labels"] == {"code": "200"}:
            v["value"] -= 1
    if stats != snap or stats_resp != resp:
        fail("GET /stats is not the registry's snapshot")
    for (name, ls), v in samples.items():
        fam = stats.get(name)
        if fam is not None and fam["type"] != "histogram" and not any(
                c["labels"] == dict(ls) and c["value"] == v
                for c in fam["values"]):
            fail(f"/metrics {name}{dict(ls)} {v} is not in /stats")
    with open(trace) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    if not {"serving.predict", "executor.step", "executor.compile"} <= names:
        fail(f"the Chrome trace holds {sorted(names)}")

    # the admitted replies against the CPU path
    ref = Replica(ModelBundle(model_dir), 0, pt.CPUPlace())
    worst = 0.0
    for i, (images, _, code, body) in enumerate(replies):
        if code != 200:
            continue
        got = np.asarray(body["outputs"][0], np.float32)
        (cpu,) = ref.run({"img": images})
        if got.shape != (len(images), 1000) or not np.isfinite(got).all():
            fail(f"reply {i}: shape {got.shape} or non-finite values")
        worst = max(worst, float(np.abs(got - cpu).max()))
        if not np.allclose(got, cpu, **PROBS_TOL) or not (
                got.argmax(1) == cpu.argmax(1)).all():
            fail(f"reply {i}: card vs CPU differ by {worst:.3e} or in "
                 f"argmax (tolerance {PROBS_TOL})")
    log(f"{n200} admitted replies match the CPU path: max abs err "
        f"{worst:.3e} (tolerance {PROBS_TOL}); {n429} refused with 429")
    del ref

    # Executor.run at bucket 32 with telemetry, then with trace_ops
    rep = Replica(ModelBundle(model_dir), 0)
    prog = rep.bundle.program
    label = prog.fingerprint()[:12]
    x = torch.randn(SERVE_BATCH, 3, 224, 224, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))

    def median_run():
        for _ in range(3):
            rep.run({"img": x})
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            rep.run({"img": x})     # returns numpy: ends in a device sync
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3

    def plan_misses():
        return prom_total(parse_prometheus(obs.render_prometheus()),
                          "executor_compile_cache_miss_total", program=label)

    plain_ms = median_run()
    op_types = [op.type for op in prog.global_block().ops
                if op.type not in ("feed", "fetch")]
    try:
        FLAGS.set("trace_ops", True)
        before = plan_misses()
        rep.run({"img": x})
        first_missed = plan_misses() - before
        traced_ms = median_run()
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            rep.run({"img": x})
        ranges = [e.name for e in prof.events() if e.name in set(op_types)]
    finally:
        FLAGS.set("trace_ops", False)
    if first_missed != 1 or plan_misses() - before != 1:
        fail(f"trace_ops: the first traced run missed {first_missed} "
             "times, and later ones must hit")
    if sorted(ranges) != sorted(op_types):
        fail(f"trace_ops: {len(ranges)} record_function ranges for "
             f"{len(op_types)} ops")
    log(f"Executor.run at bucket {SERVE_BATCH}, median of 10: "
        f"{plain_ms:.3f} ms with telemetry (writes {overhead_us:.2f} us, "
        f"{100 * overhead_us / 1e3 / plain_ms:.4f}% of it); "
        f"{traced_ms:.3f} ms with trace_ops ({len(ranges)} ranges, "
        f"{(traced_ms - plain_ms) * 1e3 / len(ranges):+.2f} us an op)")
    log(f"phase 3b wall time {time.perf_counter() - t_phase:.1f} s")
    return launches, wgmma


def phase_throughput(dev, model_dir):
    import torch

    from paddle_tpu_torch.serving import ModelBundle, Replica

    rep = Replica(ModelBundle(model_dir), 0)
    x = torch.randn(SERVE_BATCH, 3, 224, 224, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))
    for _ in range(3):
        rep.run({"img": x})
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        rep.run({"img": x})     # returns numpy: ends in a device sync
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log(f"Executor.run at bucket {SERVE_BATCH}: median {med * 1e3:.2f} ms "
        f"per batch over 10 runs (min {min(times) * 1e3:.2f}, max "
        f"{max(times) * 1e3:.2f}) = {SERVE_BATCH / med:.1f} images/s")

    # where one forward's time goes: the profiler's device time by kernel
    from torch.profiler import ProfilerActivity, profile

    # the second profiled forward is the one kept; a later one where the
    # profiler saw no kernel (``cuda_window``)
    for attempt in range(6):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rep.run({"img": x})
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")]
        if attempt and kernels:
            break
        if attempt:
            log(f"profiled forward, window {attempt + 1}: the profiler saw "
                "no kernel; taken again")
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"one profiled forward at batch {SERVE_BATCH}: {wall_ms:.2f} ms wall, "
        f"device kernels {busy_ms:.2f} ms busy, idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}; top kernels by device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3
        log(f"  {ms:8.3f} ms {100 * ms / busy_ms:5.1f}% x{e.count:3d} "
            f"{e.key[:90]}")
    return SERVE_BATCH / med


def phase_serving_graph(dev, model_dir):
    """Phase 4b: ResNet-50 at bucket 32 through one Replica eagerly
    (disable_graphs) and through another replaying its CUDA graph (the
    warm-ups: the plan build, the capture, one replay): the replies equal
    bit for bit, the launches of one replayed forward (46 conv, all on
    wgmma, 1 matmul, 1 softmax), and Executor.run's median ms of 10
    each."""
    import torch

    from paddle_tpu_torch.executor import disable_graphs
    from paddle_tpu_torch.serving import ModelBundle, Replica

    bundle = ModelBundle(model_dir)
    x = torch.randn(SERVE_BATCH, 3, 224, 224, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))

    def median_run(rep):
        for _ in range(3):
            out = rep.run({"img": x})
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            out = rep.run({"img": x})   # returns numpy: a device sync
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3, out[0]

    with disable_graphs():
        eager_ms, eager_out = median_run(Replica(bundle, 0))
    rep = Replica(bundle, 1)
    graph_ms, graph_out = median_run(rep)
    stats = rep.exe.graph_stats()
    zero_counters()
    rep.run({"img": x})
    launches, wgmma = counters(), wgmma_counters()
    log(f"Executor.run at bucket {SERVE_BATCH}, median of 10: eager "
        f"{eager_ms:.3f} ms, replayed from its CUDA graph {graph_ms:.3f} ms "
        f"({eager_ms / graph_ms:.2f}x); {stats['graphs']} graph, pool "
        f"{stats['pool_bytes'] / 2**20:.1f} MiB; replies equal bit for bit: "
        f"{np.array_equal(graph_out, eager_out)}; one replayed forward "
        f"launched conv {launches['conv2d_nhwc']} (wgmma "
        f"{wgmma['conv2d_nhwc']}), matmul {launches['matmul']}, softmax "
        f"{launches['softmax']}")
    if stats["graphs"] != 1:
        fail(f"the bucket-{SERVE_BATCH} forward was not captured: {stats}")
    if not np.array_equal(graph_out, eager_out):
        fail(f"graph replies differ from eager by "
             f"{np.abs(graph_out - eager_out).max():.3e}")
    if (launches["conv2d_nhwc"], wgmma["conv2d_nhwc"], launches["matmul"],
            launches["softmax"]) != (46, 46, 1, 1):
        fail(f"a replayed forward's launches: {launches}, {wgmma}")
    return dict(eager_ms=eager_ms, graph_ms=graph_ms)


# ---------------------------------------------------------------------------
# phases 5-7: training
# ---------------------------------------------------------------------------


def build_training_program():
    """The ResNet-50 training program bench.py builds, in the port:
    full width, mean(cross_entropy(softmax fc)), Momentum(0.1, 0.9), f32.
    Returns (main, startup, pred, loss, params_grads)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import resnet_imagenet

    pt.framework.reset_default_programs()
    main_prog = pt.default_main_program()
    startup = pt.default_startup_program()
    main_prog.seed = startup.seed = 2026
    img = pt.layers.data(name="img", shape=[3, 224, 224])
    label = pt.layers.data(name="label", shape=[1], dtype="int64")
    pred = resnet_imagenet(img, class_dim=1000, depth=50)
    loss = pt.layers.mean(pt.layers.cross_entropy(input=pred, label=label))
    _, params_grads = pt.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9).minimize(loss)
    return main_prog, startup, pred, loss, params_grads


def _scaled_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        return float("inf")
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    return err / scale if scale else err


def parity_feed(rng, image=(3, 224, 224), classes=1000):
    """PARITY_BATCH seeded images and labels."""
    return {"img": rng.randn(PARITY_BATCH, *image).astype(np.float32),
            "label": rng.randint(0, classes, (PARITY_BATCH, 1)).astype(
                np.int64)}


def phase_train_parity(dev, main_prog, startup, loss, params_grads,
                       image=(3, 224, 224), classes=1000, what="train-step"):
    """One train step on the card against the same step on the CPU, end to
    end and op by op (ResNet-50's; with ``image`` and ``classes``, an
    image cell's).

    End to end, from identical weights and feeds: the loss and the BN
    running statistics within PARITY_TOL of the CPU's largest magnitude.
    The gradients (and so the velocities and updated parameters) of a
    randomly initialised ResNet-50 at batch 2 are ill-conditioned: a
    relative perturbation of 1e-6 of the images moves some of them by up
    to a quarter of their largest element (batch norm over 2 x 7 x 7 rows
    removes nearly all of the incoming gradient in the last stage,
    leaving a small difference of large terms).  So the CPU step also
    runs on the images perturbed by PERTURB, and each of those tensors is
    held end to end to max(PARITY_TOL * max|CPU|, FLOOR_FACTOR * the
    spread between the two CPU steps).

    Op by op: every op of the step (forward, grad ops, sums, updates)
    runs on the card and, on copies of the very same input values, on
    the CPU; each output within OP_TOL of the CPU output's largest
    magnitude.  That holds every gradient, velocity and updated parameter
    without the amplification."""
    import torch

    import paddle_tpu_torch as pt

    card = pt.Executor()
    scope = pt.Scope()
    card.run(startup, scope=scope)
    state = {n: v.cpu().numpy() for n, v in scope.values.items()}
    rng = np.random.RandomState(5)
    feed = parity_feed(rng, image, classes)
    fetch = [loss.name] + [g.name for _, g in params_grads]
    t0 = time.perf_counter()
    got = card.run(main_prog, feed=feed, fetch_list=fetch, scope=scope)
    t_card = time.perf_counter() - t0
    cpu = pt.Executor(pt.CPUPlace())
    runs = []
    t0 = time.perf_counter()
    for eps in (0.0, PERTURB):
        cpu_scope = pt.Scope()
        cpu_scope.load_numpy(state, "cpu")
        img = feed["img"] * (1 + eps * rng.randn(*feed["img"].shape)
                             ).astype(np.float32)
        out = cpu.run(main_prog, feed={"img": img, "label": feed["label"]},
                      fetch_list=fetch, scope=cpu_scope)
        out += [cpu_scope.get(n).numpy() for n in sorted(state)]
        runs.append(out)
    t_cpu = (time.perf_counter() - t0) / 2
    got += [scope.get(n).cpu().numpy() for n in sorted(state)]
    names = fetch + sorted(state)

    block = main_prog.global_block()
    bn_stats = {n for op in block.ops if op.type == "batch_norm"
                for n in op.input("Mean") + op.input("Variance")}
    params = {p.name for p, _ in params_grads}
    worst, floor_held, bad = {}, 0, []
    for i, name in enumerate(names):
        kind = ("loss" if name == loss.name else
                "gradient" if i < len(fetch) else
                "BN running statistic" if name in bn_stats else
                "parameter" if name in params else
                "velocity" if "velocity" in name else "other state")
        want = np.asarray(runs[0][i], np.float64)
        g = np.asarray(got[i], np.float64)
        scale = float(np.abs(want).max()) if want.size else 0.0
        spread = float(np.abs(np.asarray(runs[1][i], np.float64) - want).max())
        err = float(np.abs(g - want).max()) if np.isfinite(g).all() else np.inf
        allowed = PARITY_TOL * scale
        if kind not in ("loss", "BN running statistic"):
            floor_held += FLOOR_FACTOR * spread > allowed
            allowed = max(allowed, FLOOR_FACTOR * spread)
        rel, rel_spread = (err / scale, spread / scale) if scale else (err, spread)
        if rel > worst.get(kind, (-1.0,))[0]:
            worst[kind] = (rel, rel_spread, name)
        if not err <= allowed:
            bad.append((name, err, allowed))
    log(f"{what} parity at batch {PARITY_BATCH}, end to end (card "
        f"{t_card:.2f} s, CPU plain path {t_cpu:.2f} s per step): loss card "
        f"{float(got[0]):.6f} vs CPU {float(runs[0][0]):.6f}; "
        f"{len(params_grads)} gradients and {len(state)} state tensors, "
        f"{floor_held} of them held to {FLOOR_FACTOR} x the CPU's own spread "
        f"under a {PERTURB} perturbation of the images; worst "
        "max|card - CPU| / max|CPU| per kind (the CPU's spread beside it):")
    for kind, (rel, rel_spread, name) in sorted(worst.items()):
        log(f"  {kind}: {rel:.3e} (spread {rel_spread:.3e}; {name})")
    if bad:
        fail(f"train step on the card differs from the CPU end to end: "
             f"{bad[:10]}")

    ops_on_identical_inputs(dev, block, state, feed,
                            f"{what} parity at batch {PARITY_BATCH}")
    del scope, got, runs
    torch.cuda.empty_cache()
    return worst


def phase_amp_parity(dev, main_prog, startup, loss, image=(3, 224, 224),
                     classes=1000, what="AMP step"):
    """One AMP step on the card against the same AMP step on the CPU (the
    kernels' plain versions), from identical weights and feeds, end to
    end: the loss within AMP_PARITY_TOL of its value, each BN running
    statistic within max(AMP_PARITY_TOL * max|CPU|, FLOOR_FACTOR * the
    CPU's bf16 effect), the effect being max|CPU AMP step - CPU f32 step|
    from the same start; then every op on identical inputs within
    AMP_OP_TOL.  The gradients are held op by op only: at batch 2 they are
    ill-conditioned (phase_train_parity), and bf16 rounding at other
    places moves them by tens of percent end to end."""
    import torch

    import paddle_tpu_torch as pt

    card = pt.Executor()
    scope = pt.Scope()
    card.run(startup, scope=scope)
    state = {n: v.cpu().numpy() for n, v in scope.values.items()}
    rng = np.random.RandomState(6)
    feed = parity_feed(rng, image, classes)
    block = main_prog.global_block()
    stats = sorted({n for op in block.ops if op.type == "batch_norm"
                    for n in op.input("Mean") + op.input("Variance")})
    with pt.amp.amp_guard(True):
        zero_counters()
        t0 = time.perf_counter()
        (got,) = card.run(main_prog, feed=feed, fetch_list=[loss], scope=scope)
        t_card = time.perf_counter() - t0
        launches = counters()
        cpu = pt.Executor(pt.CPUPlace())
        scopes, losses = {}, {}
        t0 = time.perf_counter()
        for amp in (True, False):
            scopes[amp] = pt.Scope()
            scopes[amp].load_numpy(state, "cpu")
            with pt.amp.amp_guard(amp):
                (losses[amp],) = cpu.run(main_prog, feed=feed,
                                         fetch_list=[loss],
                                         scope=scopes[amp])
        t_cpu = (time.perf_counter() - t0) / 2
    if launches != launches_implied(main_prog, amp=True):
        fail(f"{what} at batch {PARITY_BATCH}: launches {launches}")
    want = losses[True]
    rel_loss = abs(float(got) - float(want)) / abs(float(want))
    bad = [(loss.name, rel_loss)] if not rel_loss <= AMP_PARITY_TOL else []
    worst, floor_held = (0.0, 0.0, ""), 0
    for name in stats:
        g = scope.get(name).cpu().numpy().astype(np.float64)
        w = scopes[True].get(name).numpy().astype(np.float64)
        f = scopes[False].get(name).numpy().astype(np.float64)
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max()) if np.isfinite(g).all() else np.inf
        effect = float(np.abs(w - f).max())
        allowed = max(AMP_PARITY_TOL * scale, FLOOR_FACTOR * effect)
        floor_held += FLOOR_FACTOR * effect > AMP_PARITY_TOL * scale
        worst = max(worst, (err / scale, effect / scale, name))
        if not err <= allowed:
            bad.append((name, err, allowed))
    log(f"{what} parity at batch {PARITY_BATCH}, end to end (card "
        f"{t_card:.2f} s, CPU plain path {t_cpu:.2f} s a step): loss card "
        f"{float(got):.6f} vs CPU {float(want):.6f} (rel {rel_loss:.2e}; the "
        f"CPU's f32 step {float(losses[False]):.6f}); {len(stats)} BN "
        f"running statistics, {floor_held} of them held to {FLOOR_FACTOR} x "
        f"the CPU's own bf16 effect; worst max|card - CPU| / max|CPU| "
        f"{worst[0]:.3e} ({worst[2]}; its bf16 effect {worst[1]:.3e}; "
        f"tolerance {AMP_PARITY_TOL})")
    if bad:
        fail(f"AMP step on the card differs from the CPU end to end: "
             f"{bad[:10]}")
    with pt.amp.amp_guard(True):
        ops_on_identical_inputs(dev, block, state, feed,
                                f"{what} parity at batch {PARITY_BATCH}",
                                tol=AMP_OP_TOL)
    del scope, scopes
    torch.cuda.empty_cache()


def _moved(v, device):
    """A run value on ``device``: a tensor, a LoD value (its rows and
    offsets), a SparseGrad (its rows and values) or a residual tuple (the
    LSTM's hs, cs and gates); a LoD feed given as (array, [offsets])
    becomes a LoD value."""
    import torch

    from paddle_tpu_torch.lod import LoDArray, create_lod_array
    from paddle_tpu_torch.sparse import SparseGrad

    if isinstance(v, tuple) and len(v) == 2 and isinstance(v[1], list):
        v = create_lod_array(v[0], v[1])
    if isinstance(v, LoDArray):
        return LoDArray(v.data.to(device), [o.to(device) for o in v.lod])
    if isinstance(v, SparseGrad):
        return SparseGrad(v.rows.to(device), v.values.to(device), v.height)
    if isinstance(v, tuple):
        return tuple(t.to(device) for t in v)
    return torch.as_tensor(v, device=device)


def pre_bn_bias_grads(block):
    """{Y@GRAD: Out@GRAD} of the bias adds whose output feeds a training
    batch_norm (VGG-16's conv biases): BN takes out every per-channel
    shift, so such a bias's gradient, the sum of Out@GRAD over the rows,
    is zero but for rounding; ``ops_on_identical_inputs`` holds it
    relative to the terms it sums, where a test relative to itself would
    hold noise to noise."""
    bn_x = {op.input("X")[0] for op in block.ops
            if op.type == "batch_norm" and not op.attr("is_test", False)}
    return {op.output("Y@GRAD")[0]: op.input("Out@GRAD")[0]
            for op in block.ops if op.type == "elementwise_add_grad"
            and op.attr("__fwd_outputs__")["Out"][0] in bn_x
            and op.output("Y@GRAD") and op.output("Y@GRAD")[0]}


def ops_on_identical_inputs(dev, block, state, feed, what, tol=OP_TOL,
                            only=None):
    """Every op of ``block`` (forward, grad ops, sums, updates) on the card
    and, on copies of the very same input values, on the CPU: each output
    within ``tol`` of the CPU output's largest magnitude (a bias gradient
    in front of a training BN: of the terms it sums, ``pre_bn_bias_grads``).
    A grad op gets the residual its forward left for it (the attention's
    logsumexp, the LSTM's gates) on both sides.  With ``only`` (a set of op types), the
    other ops run on the card alone, to make the compared ops' inputs."""
    import torch

    from paddle_tpu_torch.lod import unwrap
    from paddle_tpu_torch.ops.attention_ops import lse_name
    from paddle_tpu_torch.ops.sequence_ops import gates_name
    from paddle_tpu_torch.registry import LowerContext, OpRegistry
    from paddle_tpu_torch.sparse import SparseGrad

    cpu_dev = torch.device("cpu")
    bias_terms = pre_bn_bias_grads(block)
    values = {n: _moved(v, dev) for n, v in state.items()}
    values.update({k: _moved(v, dev) for k, v in feed.items()})
    op_worst, op_bad, n_out = [], [], 0
    t0 = time.perf_counter()
    with torch.no_grad():
        for op in block.ops:
            info = OpRegistry.get(op.type)
            if only is not None and op.type not in only:
                info.lower(LowerContext(op, values, dev))
                continue
            names = [n for n in op.input_arg_names if n]
            names += [r(n) for n in names for r in (lse_name, gates_name)
                      if r(n) in values]
            twin = {n: _moved(values[n], cpu_dev) for n in names
                    if n in values}
            info.lower(LowerContext(op, values, dev))
            info.lower(LowerContext(op, twin, cpu_dev))
            for n in op.output_arg_names:
                if not n or n not in twin:
                    continue
                want, g = twin[n], values[n]
                if isinstance(want, SparseGrad):
                    # the same rows, then the rows' values
                    if not torch.equal(g.rows.cpu(), want.rows):
                        op_bad.append((op.type, n, "rows", None))
                    want, g = want.values, g.values
                want = unwrap(want).double()
                g = unwrap(g).cpu().double()
                scale = float(want.abs().max()) if want.numel() else 0.0
                if n in bias_terms:
                    scale = max(scale, float(unwrap(
                        twin[bias_terms[n]]).double().abs().max()))
                err = float((g - want).abs().max()) if want.numel() else 0.0
                n_out += 1
                op_worst.append((err / scale if scale else err, op.type, n))
                if not err <= tol * max(scale, 1e-30) and err > 0:
                    op_bad.append((op.type, n, err, scale))
    op_worst.sort(reverse=True)
    log(f"{what}, op by op on identical inputs: {len(block.ops)} ops"
        + (f" ({', '.join(sorted(only))} compared)" if only else "")
        + f", {n_out} outputs in {time.perf_counter() - t0:.1f} s; worst "
        "max|card - CPU| / max|CPU|: "
        + ", ".join(f"{t} {n} {e:.2e}" for e, t, n in op_worst[:6])
        + f" (tolerance {tol})")
    if op_bad:
        fail(f"ops on the card differ from the CPU on identical inputs: "
             f"{op_bad[:10]}")
    del values
    torch.cuda.empty_cache()


def phase_train_step(dev, main_prog, startup, loss, want_launches, smi,
                     amp=False):
    """The step at batch 256 (under AMP with ``amp``): counted launches,
    throughput, peak memory and one profiled step."""
    import paddle_tpu_torch as pt

    with pt.amp.amp_guard(amp):
        return _train_step(dev, main_prog, startup, loss, want_launches, smi,
                           "AMP bf16" if amp else "f32")


def _train_step(dev, main_prog, startup, loss, want_launches, smi, kind):
    import torch

    import paddle_tpu_torch as pt

    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    gen = torch.Generator(device=dev).manual_seed(11)
    feed = {"img": torch.randn(TRAIN_BATCH, 3, 224, 224, device=dev,
                               generator=gen),
            "label": torch.randint(0, 1000, (TRAIN_BATCH, 1), device=dev,
                                   generator=gen)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    t0 = time.perf_counter()
    (first,) = exe.run(main_prog, feed=feed, fetch_list=[loss], scope=scope)
    first_s = time.perf_counter() - t0
    launches = counters()
    wgmma = wgmma_counters()
    log(f"first {kind} train step at batch {TRAIN_BATCH}: loss "
        f"{float(first):.5f} in {first_s:.2f} s; launches "
        f"{ {k: v for k, v in launches.items() if v} }; on the wgmma "
        f"engine {wgmma}")
    if launches != want_launches:
        fail(f"train-step launch counts {launches} != {want_launches}")
    # every conv launch (C, O multiples of 64) on a wgmma engine: the f32
    # forward, backward-input and filter gradient in split TF32, the bf16
    # forward, backward-input and filter gradient; the fc (256 rows) on the
    # SIMT or mma.sync tile
    want_wgmma = dict.fromkeys(wgmma, 0)
    want_wgmma.update({
        k: want_launches[k] for k in ("conv2d_nhwc", "conv_bwd_input",
                                      "conv_dw", "conv2d_nhwc_bf16",
                                      "conv_bwd_input_bf16",
                                      "conv_dw_bf16")})
    if wgmma != want_wgmma:
        fail(f"train-step wgmma launch counts {wgmma} != {want_wgmma}")
    (second,) = exe.run(main_prog, feed=feed, fetch_list=[loss], scope=scope)
    times, losses = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        (val,) = exe.run(main_prog, feed=feed, fetch_list=[loss], scope=scope)
        times.append(time.perf_counter() - t0)   # numpy fetch: a device sync
        losses.append(float(val))
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite([float(first), float(second)] + losses)):
        fail(f"non-finite training loss: {first}, {second}, {losses}")
    img_s = 5 * TRAIN_BATCH / sum(times)
    log(f"train step at batch {TRAIN_BATCH} ({kind}): {img_s:.1f} images/s over 5 "
        f"timed steps after 2 warm-up steps ({sum(times):.3f} s; median "
        f"{statistics.median(times) * 1e3:.1f} ms, min {min(times) * 1e3:.1f},"
        f" max {max(times) * 1e3:.1f}); losses {[round(x, 5) for x in losses]};"
        f" peak memory allocated {peak / 2**30:.2f} GiB on {smi}")

    # the profiler must see every wgmma filter-gradient launch of the step
    # (bf16, or split TF32 in f32)
    idle = profile_step(lambda: exe.run(main_prog, feed=feed,
                                        fetch_list=[loss], scope=scope),
                        f"{kind} train step",
                        want={"wgmma_dw_kernel": want_wgmma["conv_dw_bf16"],
                              "wgmma_tf32_dw_kernel": want_wgmma["conv_dw"]})
    del exe, scope, feed
    torch.cuda.empty_cache()
    return dict(images_per_s=img_s, peak_bytes=peak, idle_share=idle,
                launches=launches, wgmma=wgmma)


def profile_step(run, what, split=None, want=None, host_ranges=(),
                 exact=False):
    """Profile ``run()`` twice and keep the second: wall time, device busy
    time and idle share, the top kernels by device time, the layout and
    dtype copies.  ``split`` ({part: kernel-name substrings, or the name
    of a ``record_function`` range}) logs the device time of each part
    beside the host's; ``host_ranges`` (names of ``record_function``
    ranges that span other parts' kernels) logs the host time alone
    inside each.  ``want`` ({kernel name: launches}) fails the run
    if the profiler saw fewer launches of a kernel, or with ``exact``
    other than that many.  Returns the idle
    share.  A window whose ``want`` counts fall short, or that saw no
    kernel, is profiled again after a pause, up to 5 windows in all: the
    profiler has dropped a short kernel's record from a window whose
    launch counters were right (``cuda_window``)."""
    from torch.profiler import ProfilerActivity, profile

    # a range also shows on the device timeline as an annotation spanning
    # its kernels and the gaps between them: not a kernel
    ranges = {v for v in (split or {}).values() if isinstance(v, str)}
    ranges.update(host_ranges)
    for attempt in range(5):
        if attempt:
            time.sleep(0.25 * 2 ** attempt)
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        # (device ms, count, name) of every kernel
        rows = [(e.self_device_time_total / 1e3, e.count, e.key)
                for e in events if str(e.device_type).endswith("CUDA")
                and e.key not in ranges]
        short = {k: sum(r[1] for r in rows if k in r[2])
                 for k in (want or {})}
        short = {k: v for k, v in short.items() if v < want[k]}
        if rows and not short:
            break
        log(f"profiled {what}, window {attempt + 1}: the profiler saw "
            f"{short} launches of {len(rows)} kernels, want {want}")
    for kernel, n in (want or {}).items():
        seen = sum(r[1] for r in rows if kernel in r[2])
        if seen < n or (exact and seen != n):
            fail(f"profiled {what}: the profiler saw {seen} launches of "
                 f"{kernel}, not {n}")
        if n:
            log(f"profiled {what}: {kernel} x{seen}, "
                f"{sum(r[0] for r in rows if kernel in r[2]):.3f} ms on the "
                "device")
    busy_ms = sum(r[0] for r in rows)
    idle = max(0.0, 1 - busy_ms / wall_ms)
    log(f"one profiled {what}: {wall_ms:.1f} ms wall, device kernels "
        f"{busy_ms:.1f} ms busy, idle share {idle:.3f}; top kernels by "
        "device time:")
    for ms, n, key in sorted(rows, key=lambda r: -r[0])[:16]:
        log(f"  {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% x{n:4d} {key[:100]}")
    copies = [r for r in rows if "copy" in r[2].lower()]
    copy_calls = sum(e.count for e in events if e.key == "aten::copy_")
    log(f"layout/dtype copies: {sum(r[1] for r in copies)} device copy "
        f"kernels, {sum(r[0] for r in copies):.2f} ms; {copy_calls} "
        "aten::copy_ calls")
    if split:
        parts, host = {}, {}

        def spans(name):
            return [e for e in events if e.key == name
                    and not str(e.device_type).endswith("CUDA")]

        for part, pats in split.items():
            if isinstance(pats, str):   # a range: the kernels launched in it
                parts[part] = sum(e.device_time_total
                                  for e in spans(pats)) / 1e3
                host[part] = sum(e.cpu_time_total for e in spans(pats)) / 1e3
            else:
                parts[part] = sum(r[0] for r in rows
                                  if any(p in r[2] for p in pats))
        for name in host_ranges:
            host[name] = sum(e.cpu_time_total for e in spans(name)) / 1e3
        parts["other device kernels"] = busy_ms - sum(parts.values())
        log(f"where the {what}'s {wall_ms:.1f} ms go, by device time: "
            + "; ".join(f"{k} {v:.2f} ms ({100 * v / wall_ms:.1f}%)"
                        for k, v in parts.items())
            + f"; host, device idle {wall_ms - busy_ms:.2f} ms "
            f"({100 * (wall_ms - busy_ms) / wall_ms:.1f}%); host time inside "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in host.items()))
    return idle


def phase_lenet(dev, amp=False):
    """LeNet-5 with Adam on the card, the mirror of
    tests/test_book_convergence.py::test_recognize_digits_conv; under AMP
    with ``amp`` (its 5x5 unpadded convs on the library in bf16, its fc
    products on the bf16 matmul kernel)."""
    import paddle_tpu_torch as pt

    with pt.amp.amp_guard(amp):
        _lenet(dev, "AMP bf16" if amp else "f32")


def _lenet(dev, kind):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import lenet5

    main_prog, startup = pt.Program(), pt.Program()
    main_prog.seed = startup.seed = 7
    with pt.program_guard(main_prog, startup):
        img = pt.layers.data(name="img", shape=[1, 28, 28])
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        pred = lenet5(img)
        loss = pt.layers.mean(pt.layers.cross_entropy(input=pred,
                                                      label=label))
        acc = pt.layers.accuracy(input=pred, label=label)
        pt.optimizer.Adam(learning_rate=0.001).minimize(loss)
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(42)
    protos = rng.randn(10, 1, 28, 28).astype("float32")
    t0 = time.perf_counter()
    for _ in range(40):
        ys = rng.randint(0, 10, (64,)).astype("int64")
        xs = protos[ys] + 0.3 * rng.randn(64, 1, 28, 28).astype("float32")
        lv, av = exe.run(main_prog, feed={"img": xs,
                                          "label": ys.reshape(-1, 1)},
                         fetch_list=[loss, acc], scope=scope)
    log(f"LeNet-5 + Adam ({kind}), 40 steps of 64 on {exe.place!r} in "
        f"{time.perf_counter() - t0:.2f} s: final loss {float(lv):.4f}, "
        f"accuracy {float(av[0]):.3f}")
    if not float(av[0]) > 0.9:
        fail(f"LeNet-5 ({kind}) did not converge: accuracy "
             f"{float(av[0]):.3f}")


def amp_step_parity(dev, main_prog, startup, loss, params_grads, feed,
                    what):
    """One AMP step on the card against the same AMP step on CPUPlace()
    from identical weights and feeds, end to end: the loss within
    AMP_PARITY_TOL of its value; every gradient, and every persistable
    after the update, within max(AMP_PARITY_TOL * max|CPU|, FLOOR_FACTOR *
    the CPU's own bf16 effect on it), the effect being max|CPU AMP step -
    CPU f32 step| from the same start (bf16 sums that a kernel and its
    plain version round an ulp apart move a tensor by about what bf16
    itself moves it); then every op on identical inputs within
    AMP_OP_TOL."""
    import torch

    import paddle_tpu_torch as pt

    card = pt.Executor()
    scope = pt.Scope()
    card.run(startup, scope=scope)
    state = {n: v.cpu().numpy() for n, v in scope.values.items()}
    fetch = [loss.name] + [g.name for _, g in params_grads]
    names = fetch + sorted(state)
    t0 = time.perf_counter()
    with pt.amp.amp_guard(True):
        got = card.run(main_prog, feed=feed, fetch_list=fetch, scope=scope)
    t_card = time.perf_counter() - t0
    got = [_host_dense(v) for v in got]
    got += [scope.get(n).cpu().numpy() for n in sorted(state)]
    del scope
    torch.cuda.empty_cache()
    runs = {}
    t0 = time.perf_counter()
    for amp in (True, False):
        cpu_scope = pt.Scope()
        cpu_scope.load_numpy(state, "cpu")
        with pt.amp.amp_guard(amp):
            out = pt.Executor(pt.CPUPlace()).run(
                main_prog, feed=feed, fetch_list=fetch, scope=cpu_scope)
        runs[amp] = [_host_dense(v) for v in out] + [
            cpu_scope.get(n).numpy() for n in sorted(state)]
        del cpu_scope
    t_cpu = (time.perf_counter() - t0) / 2
    want_loss = float(runs[True][0])
    rel_loss = abs(float(got[0]) - want_loss) / abs(want_loss)
    bad = [(loss.name, rel_loss)] if not rel_loss <= AMP_PARITY_TOL else []
    worst, floor_held = {}, 0
    params = {p.name for p, _ in params_grads}
    for i, name in enumerate(names[1:], 1):
        kind = ("gradient" if i < len(fetch) else
                "parameter" if name in params else "optimizer state")
        w = np.asarray(runs[True][i], np.float64)
        f = np.asarray(runs[False][i], np.float64)
        g = np.asarray(got[i], np.float64)
        scale = float(np.abs(w).max()) if w.size else 0.0
        effect = float(np.abs(w - f).max()) if w.size else 0.0
        err = (float(np.abs(g - w).max()) if np.isfinite(g).all() else np.inf
               ) if w.size else 0.0
        allowed = max(AMP_PARITY_TOL * scale, FLOOR_FACTOR * effect)
        floor_held += FLOOR_FACTOR * effect > AMP_PARITY_TOL * scale
        rel = (err / scale, effect / scale) if scale else (err, effect)
        if rel > worst.get(kind, (-1.0,)):
            worst[kind] = rel + (name,)
        if not err <= allowed:
            bad.append((name, err, allowed))
    log(f"{what}, AMP step end to end (card {t_card:.2f} s, CPU plain path "
        f"{t_cpu:.2f} s a step): loss card {float(got[0]):.6f} vs CPU "
        f"{want_loss:.6f} (rel {rel_loss:.2e}, tolerance {AMP_PARITY_TOL}; "
        f"the CPU's f32 step {float(runs[False][0]):.6f}); "
        f"{len(names) - 1} gradients and state tensors, {floor_held} of them "
        f"held to {FLOOR_FACTOR} x the CPU's own bf16 effect; worst "
        "max|card - CPU| / max|CPU| per kind (the bf16 effect beside it):")
    for kind, (rel, eff, name) in sorted(worst.items()):
        log(f"  {kind}: {rel:.3e} (bf16 effect {eff:.3e}; {name})")
    if bad:
        fail(f"{what}: the AMP step on the card differs from the CPU end to "
             f"end: {bad[:10]}")
    del got, runs
    with pt.amp.amp_guard(True):
        ops_on_identical_inputs(dev, main_prog.global_block(), state, feed,
                                f"{what}, AMP", tol=AMP_OP_TOL)


# ---------------------------------------------------------------------------
# phases 8-10: the transformer LM
# ---------------------------------------------------------------------------


def build_transformer_program(seq, config=TF_CONFIG, lr=TF_LR, seed=2026):
    """transformer_lm_loss + Adam(lr).minimize in the port, as
    benchmark/transformer_bench.py builds it.  Returns (main, startup,
    loss, params_grads)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import transformer_lm_loss

    pt.framework.reset_default_programs()
    main_prog = pt.default_main_program()
    startup = pt.default_startup_program()
    main_prog.seed = startup.seed = seed
    tokens = pt.layers.data(name="tokens", shape=[seq, 1], dtype="int64")
    labels = pt.layers.data(name="labels", shape=[seq, 1], dtype="int64")
    loss = transformer_lm_loss(tokens, labels=labels, **config)
    _, params_grads = pt.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main_prog, startup, loss, params_grads


def phase_tf_parity(dev):
    """One full-width transformer step (B 1, S 128) on the card against
    the same step on CPUPlace(), end to end and op by op.

    End to end, from identical weights and tokens: the loss within
    TF_PARITY_TOL of the CPU's.  The gradients, and so the Adam moments
    and updated parameters, are ill-conditioned at 128 tokens: a
    pre-activation of the ffn's relu within rounding of zero flips its
    gate, which moves a column of ffn1's weight gradient by a few percent
    of the tensor's largest element, and Adam's first step turns a
    gradient near zero into a parameter move of up to lr of either sign
    (a bias that starts at zero then differs by up to twice its largest
    element).  So the CPU step also runs with the token embedding
    perturbed by TF_PERTURB, and each of those tensors is held to
    max(TF_PARITY_TOL * max|CPU|, FLOOR_FACTOR * the spread between the
    two CPU steps).  Op by op: every op of the step on identical inputs
    within OP_TOL, which holds every gradient and update without the
    amplification."""
    import torch

    import paddle_tpu_torch as pt

    main_prog, startup, loss, params_grads = build_transformer_program(
        TF_PARITY_SEQ)
    card = pt.Executor()
    scope = pt.Scope()
    card.run(startup, scope=scope)
    state = {n: v.cpu().numpy() for n, v in scope.values.items()}
    rng = np.random.RandomState(6)
    v = TF_CONFIG["vocab_size"]
    feed = {n: rng.randint(0, v, (TF_PARITY_BATCH, TF_PARITY_SEQ, 1))
            .astype(np.int64) for n in ("tokens", "labels")}
    fetch = [loss.name] + [g.name for _, g in params_grads]
    names = fetch + sorted(state)
    t0 = time.perf_counter()
    got = card.run(main_prog, feed=feed, fetch_list=fetch, scope=scope)
    t_card = time.perf_counter() - t0
    got += [scope.get(n).cpu().numpy() for n in sorted(state)]
    del scope
    torch.cuda.empty_cache()
    runs = []
    t0 = time.perf_counter()
    for eps in (0.0, TF_PERTURB):
        cpu_scope = pt.Scope()
        cpu_scope.load_numpy(state, "cpu")
        emb = cpu_scope.get("tok_emb")
        emb.mul_(1 + eps * torch.randn(emb.shape, generator=torch.Generator()
                                       .manual_seed(3)))
        out = pt.Executor(pt.CPUPlace()).run(main_prog, feed=feed,
                                             fetch_list=fetch,
                                             scope=cpu_scope)
        runs.append(out + [cpu_scope.get(n).numpy() for n in sorted(state)])
        del cpu_scope
    t_cpu = (time.perf_counter() - t0) / 2
    params = {p.name for p, _ in params_grads}
    worst, floor_held, bad = {}, 0, []
    for i, name in enumerate(names):
        kind = ("loss" if name == loss.name else
                "gradient" if i < len(fetch) else
                "parameter" if name in params else
                "Adam moment" if "moment" in name else "other state")
        want = np.asarray(runs[0][i], np.float64)
        g = np.asarray(got[i], np.float64)
        scale = float(np.abs(want).max()) if want.size else 0.0
        spread = float(np.abs(np.asarray(runs[1][i], np.float64)
                              - want).max())
        err = float(np.abs(g - want).max()) if np.isfinite(g).all() else np.inf
        allowed = TF_PARITY_TOL * scale
        if kind != "loss":
            floor_held += FLOOR_FACTOR * spread > allowed
            allowed = max(allowed, FLOOR_FACTOR * spread)
        rel, rel_spread = (err / scale, spread / scale) if scale else (err,
                                                                       spread)
        if rel > worst.get(kind, (-1.0,))[0]:
            worst[kind] = (rel, rel_spread, name)
        if not err <= allowed:
            bad.append((name, err, allowed))
    log(f"transformer step parity at full width, B {TF_PARITY_BATCH} S "
        f"{TF_PARITY_SEQ}, end to end (card {t_card:.2f} s, CPU plain path "
        f"{t_cpu:.2f} s per step): loss card {float(got[0]):.6f} vs CPU "
        f"{float(runs[0][0]):.6f}; {len(params_grads)} gradients and "
        f"{len(state)} state tensors, {floor_held} of them held to "
        f"{FLOOR_FACTOR} x the CPU's own spread under a {TF_PERTURB} "
        "perturbation of the token embedding; worst max|card - CPU| / "
        "max|CPU| per kind (the CPU's spread beside it; tolerance "
        f"{TF_PARITY_TOL}):")
    for kind, (rel, rel_spread, name) in sorted(worst.items()):
        log(f"  {kind}: {rel:.3e} (spread {rel_spread:.3e}; {name})")
    if bad:
        fail(f"transformer step on the card differs from the CPU end to end:"
             f" {bad[:10]}")
    del got, runs
    ops_on_identical_inputs(dev, main_prog.global_block(), state, feed,
                            f"transformer step parity at B {TF_PARITY_BATCH} "
                            f"S {TF_PARITY_SEQ}")
    del state
    phase_tf_engine_parity(dev)


def phase_tf_engine_parity(dev):
    """The f32 step's products on the split-TF32 wgmma engine against the
    CPU: at B 1, S TF_ENGINE_SEQ (B * S rows, at least WGMMA_MIN_ROWS) every
    op of the full-width step runs on the card, and each mul op also on the
    CPU on copies of its very inputs, within OP_TOL; the counters must
    show its 17 launches, all on the wgmma engine."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import matmul as kmatmul

    if TF_ENGINE_SEQ < kmatmul.WGMMA_MIN_ROWS:
        fail(f"B 1 S {TF_ENGINE_SEQ} does not reach the wgmma engine")
    main_prog, startup, _, _ = build_transformer_program(TF_ENGINE_SEQ)
    scope = pt.Scope()
    pt.Executor().run(startup, scope=scope)
    state = dict(scope.values)
    rng = np.random.RandomState(7)
    v = TF_CONFIG["vocab_size"]
    feed = {n: rng.randint(0, v, (1, TF_ENGINE_SEQ, 1)).astype(np.int64)
            for n in ("tokens", "labels")}
    torch.cuda.synchronize()
    zero_counters()
    ops_on_identical_inputs(dev, main_prog.global_block(), state, feed,
                            f"transformer step at B 1 S {TF_ENGINE_SEQ} "
                            "(products on the split-TF32 engine)",
                            only={"mul"})
    launches, wgmma = counters()["matmul"], wgmma_counters()["matmul"]
    log(f"  f32 matmul launches {launches}, on the wgmma engine {wgmma}")
    if not launches == wgmma == 17:
        fail(f"the step's products: {launches} f32 matmul launches, {wgmma} "
             "on the wgmma engine, not 17 and 17")
    del scope, state
    torch.cuda.empty_cache()


def phase_tf_amp_parity(dev):
    """One full-width transformer AMP step (B 1, S 128) on the card against
    the same step on CPUPlace(), end to end and op by op
    (amp_step_parity)."""
    main_prog, startup, loss, params_grads = build_transformer_program(
        TF_PARITY_SEQ)
    rng = np.random.RandomState(6)
    v = TF_CONFIG["vocab_size"]
    feed = {n: rng.randint(0, v, (TF_PARITY_BATCH, TF_PARITY_SEQ, 1))
            .astype(np.int64) for n in ("tokens", "labels")}
    amp_step_parity(dev, main_prog, startup, loss, params_grads, feed,
                    f"transformer step parity at full width, B "
                    f"{TF_PARITY_BATCH} S {TF_PARITY_SEQ}")


def phase_tf_train_step(dev, smi, amp=False, f32=None):
    """The full-width transformer step at B 8, S 1024 (under AMP with
    ``amp``): counted launches (flash forward 4, dq 4, dk/dv 4, matmul 17,
    softmax 0; under AMP the bf16 instances, and no f32 flash or matmul
    launch), tokens/s over 5 timed steps after 2 warm-up steps, peak
    memory.  With ``f32`` (the f32 step's result of the same run): the
    tokens/s beside it, then both steps profiled (phase_tf_profile),
    their idle shares set in both results."""
    import paddle_tpu_torch as pt

    with pt.amp.amp_guard(amp):
        return _tf_train_step(dev, smi, "AMP bf16" if amp else "f32", amp,
                              f32)


def _tf_train_step(dev, smi, kind, amp, f32):
    import torch

    import paddle_tpu_torch as pt

    main_prog, startup, loss, params_grads = build_transformer_program(TF_SEQ)
    want_launches = launches_implied(main_prog, amp)
    expect = dict.fromkeys(KERNELS, 0)
    sfx = "_bf16" if amp else ""
    expect.update({f"flash_attention_fwd{sfx}": 4,
                   f"flash_attention_dq{sfx}": 4,
                   f"flash_attention_dkv{sfx}": 4, f"matmul{sfx}": 17})
    if want_launches != expect:
        fail(f"unexpected transformer program: launches {want_launches}")
    n_params = sum(int(np.prod(p.shape)) for p, _ in params_grads)
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    feed = transformer_step_feed(dev)
    v = TF_CONFIG["vocab_size"]
    tokens = TF_BATCH * TF_SEQ
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    t0 = time.perf_counter()
    (first,) = exe.run(main_prog, feed=feed, fetch_list=[loss], scope=scope)
    first_s = time.perf_counter() - t0
    launches = counters()
    wgmma = wgmma_counters()
    log(f"transformer LM, {n_params / 1e6:.1f} M parameters: first {kind} "
        f"step at B {TF_BATCH} S {TF_SEQ}: loss {float(first):.5f} (ln V = "
        f"{np.log(v):.5f}) in {first_s:.2f} s; launches {launches}; on the "
        f"wgmma engine {wgmma}")
    if launches != want_launches:
        fail(f"transformer launch counts {launches} != {want_launches}")
    # every product (8192 rows) on a wgmma engine: split TF32 in f32
    want_wgmma = dict.fromkeys(wgmma, 0)
    want_wgmma.update(matmul=want_launches["matmul"],
                      matmul_bf16=want_launches["matmul_bf16"])
    if wgmma != want_wgmma:
        fail(f"transformer wgmma launch counts {wgmma} != {want_wgmma}")
    (second,) = exe.run(main_prog, feed=feed, fetch_list=[loss], scope=scope)
    times, losses = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        (val,) = exe.run(main_prog, feed=feed, fetch_list=[loss], scope=scope)
        times.append(time.perf_counter() - t0)   # numpy fetch: a device sync
        losses.append(float(val))
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite([float(first), float(second)] + losses)):
        fail(f"non-finite transformer loss: {first}, {second}, {losses}")
    if not losses[-1] < float(first):
        fail(f"the transformer's loss did not fall on a repeated batch: "
             f"{float(first)} -> {losses}")
    tok_s = 5 * tokens / sum(times)
    log(f"transformer step at B {TF_BATCH} S {TF_SEQ} ({kind}): {tok_s:.1f} "
        f"tokens/s over 5 timed steps after 2 warm-up steps "
        f"({sum(times):.3f} s; median {statistics.median(times) * 1e3:.1f} "
        f"ms, min {min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f}); "
        f"losses {[round(x, 5) for x in losses]}; peak memory allocated "
        f"{peak / 2**30:.2f} GiB on {smi}")
    result = dict(tokens_per_s=tok_s, peak_bytes=peak, launches=launches,
                  wgmma=wgmma)
    del exe, scope, feed
    torch.cuda.empty_cache()
    if f32 is not None:
        log(f"transformer step tokens/s, {kind} beside f32 in this run: "
            f"{tok_s:.1f} vs {f32['tokens_per_s']:.1f} "
            f"({tok_s / f32['tokens_per_s']:.2f}x)")
        idle = phase_tf_profile()
        f32["idle_share"], result["idle_share"] = idle["tf"], idle["tf_amp"]
    return result


def transformer_step_feed(dev):
    """The seeded tokens and labels of the B 8, S 1024 transformer step."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(12)
    return {n: torch.randint(0, TF_CONFIG["vocab_size"], (TF_BATCH, TF_SEQ, 1),
                             device=dev, generator=gen)
            for n in ("tokens", "labels")}


def phase_tf_profile():
    """One profiled transformer step in f32 and one under AMP, in a fresh
    process (this script with PROFILE_TF), split into the flash kernels,
    the matmul kernel, the mul backward products and the rest.  Returns
    {"tf": idle share, "tf_amp": idle share}."""
    return profile_in_child(PROFILE_TF, "transformer steps")


def copy_task(rng, batch, seq, vocab):
    """A seeded next-token task that needs attention: each label is the
    token one position back (the first, the token itself)."""
    tokens = rng.randint(0, vocab, (batch, seq, 1)).astype(np.int64)
    labels = np.concatenate([tokens[:, :1], tokens[:, :-1]], axis=1)
    return {"tokens": tokens, "labels": labels}


def phase_tf_converge(dev, amp=False):
    """A small transformer (d_model 256, 4 heads, 2 layers, vocab 64,
    S 128) learns copy_task on the card with Adam(3e-3), under AMP with
    ``amp``: the loss must fall below CONVERGE_LOSS."""
    import paddle_tpu_torch as pt

    with pt.amp.amp_guard(amp):
        _tf_converge("AMP bf16" if amp else "f32")


def _tf_converge(kind):
    import paddle_tpu_torch as pt

    config = dict(vocab_size=64, d_model=256, num_heads=4, num_layers=2,
                  ffn_mult=4)
    main_prog, startup, loss, _ = build_transformer_program(
        128, config=config, lr=3e-3, seed=7)
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(43)
    t0 = time.perf_counter()
    losses = []
    for _ in range(CONVERGE_STEPS):
        (lv,) = exe.run(main_prog, feed=copy_task(rng, 8, 128, 64),
                        fetch_list=[loss], scope=scope)
        losses.append(float(lv))
    log(f"small transformer + Adam ({kind}), {CONVERGE_STEPS} steps of 8 x "
        f"128 tokens on {exe.place!r} in {time.perf_counter() - t0:.2f} s: "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if not losses[-1] < CONVERGE_LOSS:
        fail(f"the small transformer ({kind}) did not learn the task: loss "
             f"{losses[-1]:.4f} >= {CONVERGE_LOSS}")


# ---------------------------------------------------------------------------
# phase 10d: the rest of the executor (CUDA graphs, donation, the
# verifier and the optimizer, recompute, build_callable) on the
# transformer step at full width
# ---------------------------------------------------------------------------


def _clone_state(state):
    import paddle_tpu_torch as pt

    scope = pt.Scope()
    scope.values.update({n: v.clone() for n, v in state.items()})
    return scope


def _graph_steps(exe, main_prog, loss, feed, scope, kind, graphs, smi):
    """2 warm-up and 5 timed steps of ``main_prog`` (the recompute
    transformer step, ``optimize_program=True``) through ``exe``, eagerly
    or with ``graphs`` (the warm-ups: the plan build, then the capture):
    the losses, the launch counters over the 5 timed steps, tokens/s,
    peak memory, and whether the donated parameters and moments kept
    their storage over the timed steps."""
    import torch

    from paddle_tpu_torch.executor import disable_graphs

    tokens = TF_BATCH * TF_SEQ
    losses = []
    ctx = disable_graphs() if not graphs else contextlib.nullcontext()
    with ctx:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            (lv,) = exe.run(main_prog, feed=feed, fetch_list=[loss],
                            scope=scope, optimize_program=True)
            losses.append(float(lv))
        plan = next(p for p in exe._cache.values()
                    if loss.name in p.fetch_names)
        ptrs = {n: scope.get(n).data_ptr() for n in plan.donated}
        torch.cuda.synchronize()
        zero_counters()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            (lv,) = exe.run(main_prog, feed=feed, fetch_list=[loss],
                            scope=scope, optimize_program=True)
            times.append(time.perf_counter() - t0)  # numpy fetch: a sync
            losses.append(float(lv))
        launches, wgmma = counters(), wgmma_counters()
        peak = torch.cuda.max_memory_allocated()
    moved = sorted(n for n in plan.donated
                   if scope.get(n).data_ptr() != ptrs[n])
    tok_s = 5 * tokens / sum(times)
    what = "graphs" if graphs else "eager"
    log(f"recompute transformer step, {kind}, {what}: {tok_s:.1f} tokens/s "
        f"over 5 timed steps after 2 warm-up steps (median "
        f"{statistics.median(times) * 1e3:.1f} ms, min "
        f"{min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f}); losses "
        f"{losses}; launches over the 5 {dict((k, v) for k, v in launches.items() if v)}; "
        f"peak memory allocated {peak / 2**30:.2f} GiB on {smi}; "
        f"{len(plan.donated)} donated tensors, {len(moved)} moved storage")
    if moved:
        fail(f"donated state changed storage across steps ({what}): "
             f"{moved[:5]}")
    if graphs and not plan.capturable:
        fail(f"the recompute transformer step was not captured: "
             f"{plan.eager_reasons}")
    return dict(losses=losses, launches=launches, wgmma=wgmma,
                tokens_per_s=tok_s, peak_bytes=peak,
                ms=statistics.median(times) * 1e3)


def _graph_vs_eager(dev, smi, main_prog, loss, feed, state, kind, want):
    """The recompute step eagerly and with graphs from the same state:
    losses within 1e-6 relative (and whether bit for bit), the counters
    equal, and equal to 5 x the launches the program implies."""
    import torch

    import paddle_tpu_torch as pt

    runs = {}
    for graphs in (False, True):
        scope = _clone_state(state)
        exe = pt.Executor()
        runs[graphs] = _graph_steps(exe, main_prog, loss, feed, scope, kind,
                                    graphs, smi)
        runs[graphs]["scope"] = scope
        runs[graphs]["stats"] = exe.graph_stats()
        runs[graphs]["report"] = exe.optimize_report(main_prog, feed,
                                                     (loss.name,))
        del exe
    eager, graph = runs[False], runs[True]
    rel = max(abs(a - b) / abs(b) for a, b in zip(graph["losses"],
                                                    eager["losses"]))
    bitwise = graph["losses"] == eager["losses"]
    same_state = all(torch.equal(graph["scope"].get(n),
                                 eager["scope"].get(n))
                     for n in eager["scope"].keys())
    log(f"{kind}: graph losses vs eager: largest relative difference "
        f"{rel:.3e}, bit for bit: {bitwise}; state after 7 steps bit for "
        f"bit: {same_state}; the graph's pool "
        f"{graph['stats']['pool_bytes'] / 2**30:.2f} GiB; graph "
        f"{graph['tokens_per_s'] / eager['tokens_per_s']:.3f}x the eager "
        "tokens/s")
    if rel > 1e-6:
        fail(f"{kind}: graph losses {graph['losses']} differ from eager "
             f"{eager['losses']} by {rel:.3e} relative")
    if graph["launches"] != eager["launches"]:
        fail(f"{kind}: launches under replay {graph['launches']} != eager "
             f"{eager['launches']}")
    five = {k: 5 * v for k, v in want.items()}
    if eager["launches"] != five:
        fail(f"{kind}: 5 recompute steps launched {eager['launches']}, the "
             f"program implies {five}")
    for r in runs.values():
        del r["scope"]
    torch.cuda.empty_cache()
    return eager, graph


def phase_executor_graphs(dev, smi):
    """Phase 10d: the recompute transformer step at full width (B 8, S
    1024, TF_CONFIG with recompute=True: each block and the head one
    segment) with check_program on and optimize_program=True.  Logs the
    OptReport and the donation mask; a dangling fetch raises
    ProgramVerificationError before any launch; the step eagerly
    (disable_graphs) and captured as a CUDA graph, f32 and under AMP, 2
    warm-up and 5 timed steps each from one state: losses equal within
    1e-6 relative, the counters equal (and 5 x launches_implied: matmul
    34, flash forward 8, dq 4, dk/dv 4), the donated parameters and
    moments keep their storage, tokens/s, peak memory; the idle shares
    profiled in a child process (PROFILE_GRAPHS); recompute against the
    direct program: the first loss and the parameters after one step
    within TF_PARITY_TOL of max, the peak memory of both; build_callable's
    5 chained calls captured in one torch.cuda.graph: the 5th loss
    equal to the 5th Executor.run step's within 1e-6 relative."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.analysis import ProgramVerificationError
    from paddle_tpu_torch.flags import FLAGS

    t_phase = time.perf_counter()
    config = dict(TF_CONFIG, recompute=True)
    main_prog, startup, loss, _ = build_transformer_program(TF_SEQ,
                                                            config=config)
    want = launches_implied(main_prog)
    expect = dict.fromkeys(KERNELS, 0)
    expect.update(flash_attention_fwd=8, flash_attention_dq=4,
                  flash_attention_dkv=4, matmul=34)
    if want != expect:
        fail(f"unexpected recompute transformer program: launches {want}")
    want_amp = launches_implied(main_prog, amp=True)
    log(f"the recompute program implies a step: {want}; under AMP "
        f"{ {k: v for k, v in want_amp.items() if v} }")
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    state = {n: v.clone() for n, v in scope.values.items()}
    del exe, scope
    feed = transformer_step_feed(dev)
    FLAGS.set("check_program", True)
    try:
        # a dangling fetch: rejected at the plan miss, before any launch
        zero_counters()
        try:
            pt.Executor().run(main_prog, feed=feed,
                              fetch_list=["no_such_var"], scope=pt.Scope())
        except ProgramVerificationError as exc:
            launched = {k: v for k, v in counters().items() if v}
            log(f"a dangling fetch under check_program: "
                f"{str(exc).splitlines()[1].strip()}; launches {launched}")
            if launched or "PVE02" not in str(exc):
                fail("the dangling fetch launched kernels or was not PVE02")
        else:
            fail("a dangling fetch under check_program did not raise")
        eager, graph = _graph_vs_eager(dev, smi, main_prog, loss, feed,
                                       state, "f32", want)
        # the rewrite and the donation mask
        report = eager["report"]
        held = {n: e.reason for n, e in report.donation.items()
                if not e.eligible}
        log(f"OptReport of the recompute step: ops {report.ops_before} -> "
            f"{report.ops_after} in {report.rounds} round(s): "
            f"constant-fold {report.folds}, cse {report.cse_hits}, dce "
            f"{report.dce_ops_removed} ops and {report.dce_vars_removed} "
            f"vars; donation mask: "
            f"{sum(e.eligible for e in report.donation.values())} of "
            f"{len(report.donation)} state names eligible; held: {held}")
        with pt.amp.amp_guard(True):
            amp_eager, amp_graph = _graph_vs_eager(
                dev, smi, main_prog, loss, feed, state, "AMP bf16", want_amp)
    finally:
        FLAGS.set("check_program", False)

    # recompute against the direct program, one step from the same state
    direct_prog, _, direct_loss, _ = build_transformer_program(
        TF_SEQ, config=TF_CONFIG)
    one = {}
    for kind, prog, lossvar in (("direct", direct_prog, direct_loss),
                                ("recompute", main_prog, loss)):
        scope = _clone_state(state)
        exe = pt.Executor()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        (lv,) = exe.run(prog, feed=feed, fetch_list=[lossvar], scope=scope)
        torch.cuda.synchronize()
        names = sorted(n for n in state if n.endswith(".w_0"))[:4]
        one[kind] = dict(loss=float(lv), peak=torch.cuda.max_memory_allocated(),
                         params={n: scope.get(n).cpu().numpy()
                                 for n in names})
        del exe, scope
        torch.cuda.empty_cache()
    d, r = one["direct"], one["recompute"]
    err = _scaled_err(np.float32(r["loss"]), np.float32(d["loss"]))
    errs = {n: _scaled_err(r["params"][n], d["params"][n])
            for n in d["params"]}
    log(f"recompute vs direct, one step: loss {r['loss']:.6f} vs "
        f"{d['loss']:.6f} (scaled err {err:.3e}); parameters after it "
        f"{ {n: f'{e:.3e}' for n, e in errs.items()} }; peak memory "
        f"{r['peak'] / 2**30:.2f} GiB vs {d['peak'] / 2**30:.2f} GiB "
        f"direct")
    if max([err] + list(errs.values())) > TF_PARITY_TOL:
        fail(f"recompute vs direct beyond {TF_PARITY_TOL}: {err}, {errs}")

    # build_callable: 5 chained calls captured in one graph
    exe = pt.Executor()
    fn, st, feeds, uses_rng = exe.build_callable(
        main_prog, feed, [loss.name], _clone_state(state))
    if uses_rng:
        fail("the transformer step's callable takes a seed")
    with torch.no_grad():
        fn(st, feeds)       # warm-up outside the capture
    torch.cuda.synchronize()
    zero_counters()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        s = st
        outs = []
        for _ in range(5):
            (lv,), s = fn(s, feeds)
            outs.append(lv)
    captured = {k: v for k, v in counters().items() if v}
    g.replay()
    torch.cuda.synchronize()
    chained = [float(v) for v in outs]
    rel = abs(chained[4] - eager["losses"][4]) / abs(eager["losses"][4])
    log(f"build_callable: 5 chained calls in one CUDA graph (launches "
        f"captured {captured}): losses {chained}; the 5th against the 5th "
        f"Executor.run step {eager['losses'][4]}: {rel:.3e} relative")
    if rel > 1e-6:
        fail(f"build_callable's chained 5th loss {chained[4]} vs "
             f"{eager['losses'][4]}")
    del g, s, outs, st, feeds, fn, exe, state
    torch.cuda.empty_cache()

    idle = profile_in_child(PROFILE_GRAPHS, "graph and eager steps")
    eager["idle_share"], graph["idle_share"] = idle["eager"], idle["graph"]
    amp_eager["idle_share"] = idle["amp_eager"]
    amp_graph["idle_share"] = idle["amp_graph"]
    for kind, r in (("f32 eager", eager), ("f32 graphs", graph),
                    ("AMP eager", amp_eager), ("AMP graphs", amp_graph)):
        log(f"recompute transformer step, {kind}: {r['tokens_per_s']:.1f} "
            f"tokens/s, {r['ms']:.1f} ms, peak {r['peak_bytes'] / 2**30:.2f} "
            f"GiB, idle share {r['idle_share']}")
    log(f"phase 10d wall time {time.perf_counter() - t_phase:.1f} s")
    per_step = {k: v // 5 for k, v in graph["launches"].items()}
    per_step_amp = {k: v // 5 for k, v in amp_graph["launches"].items()}
    return dict(f32=graph, amp=amp_graph, f32_eager=eager,
                amp_eager=amp_eager, launches=per_step,
                launches_amp=per_step_amp,
                wgmma={k: v // 5 for k, v in graph["wgmma"].items()},
                wgmma_amp={k: v // 5 for k, v in amp_graph["wgmma"].items()})


def profile_graph_steps():
    """The body of ``chip_smoke.py --profile-graph-steps``: one profiled
    recompute transformer step at B 8, S 1024, eagerly and replayed from
    its CUDA graph, f32 and under AMP (profile_step after 2 warm-up steps:
    for the graph, the plan build and the capture).  In each traced step
    the profiler must see exactly the matmul, flash forward, dq and dk/dv
    launches that ``launches_implied`` derives from the program: a
    replay's launch counters are the capture's change added again, and
    this holds them to the kernels the replay really ran.  Prints
    {path: idle share} as the last line."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.executor import disable_graphs

    dev = torch.device("cuda", 0)
    prog, startup, loss, _ = build_transformer_program(
        TF_SEQ, config=dict(TF_CONFIG, recompute=True))
    feed = transformer_step_feed(dev)
    idle = {}
    for amp in (False, True):
        implied = launches_implied(prog, amp=amp)
        sfx, c = ("_bf16", "_bf16") if amp else ("_tf32", "")
        # every product of the step on a wgmma engine (PERF.md section 6)
        want = {("wgmma_gemm_kernel" if amp else "wgmma_tf32_kernel"):
                implied[f"matmul{c}"],
                f"flash_fwd{sfx}_kernel": implied[f"flash_attention_fwd{c}"],
                f"flash_dq{sfx}_kernel": implied[f"flash_attention_dq{c}"],
                f"flash_dkv{sfx}_kernel": implied[f"flash_attention_dkv{c}"]}
        if min(want.values()) < 1:
            fail(f"the recompute step implies no launch of a kernel: {want}")
        for graphs in (False, True):
            key = ("amp_" if amp else "") + ("graph" if graphs else "eager")
            ctx = disable_graphs() if not graphs else contextlib.nullcontext()
            with pt.amp.amp_guard(amp), ctx:
                exe = pt.Executor()
                scope = pt.Scope()
                exe.run(startup, scope=scope)

                def run():
                    exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)

                for _ in range(2):
                    run()
                if graphs and not exe.graph_stats()["graphs"]:
                    fail("the recompute step was not captured")
                idle[key] = profile_step(run, f"recompute step ({key})",
                                         want=want, exact=True)
            del exe, scope
            torch.cuda.empty_cache()
    print(json.dumps(idle), flush=True)


# ---------------------------------------------------------------------------
# phases 11-16: the LSTM text classifier, padded and over LoD ids
# ---------------------------------------------------------------------------


def lstm_work(b, t, h, itemsize=4):
    """(FLOPs, bytes) of one whole-sequence LSTM forward: the T recurrent
    products; xproj, h0, c0 (``itemsize`` bytes) and W, bias (float32)
    read once, hs, cs and the gates written once."""
    return (2.0 * t * b * h * 4 * h,
            itemsize * (2 * b * t * 4 * h + 2 * b * h + 2 * b * t * h)
            + 4.0 * (4 * h * h + 4 * h))


def lstm_bwd_work(b, t, h, itemsize=4):
    """(FLOPs, bytes) of one LSTMSeq backward (``lstm_seq_bwd``: the
    kernel, then dW, dbias and the casts): the T recurrent products
    dgates_t W^T and the dW product over T B rows; the gates, hs, cs, dhs,
    dcs, h0 and c0 (``itemsize`` bytes) and W read once, dxproj, dh0, dc0
    (``itemsize``), dW and dbias (float32) written once."""
    return (4.0 * t * b * h * 4 * h,
            itemsize * (2 * b * t * 4 * h + 4 * b * t * h + 4 * b * h)
            + 4.0 * (2 * 4 * h * h + 4 * h))


def _kernel_device_ms(fn, name):
    """Device ms a call of the kernels whose names contain ``name``, from
    one profiled window (``device_ms``); None where the profiler saw
    none."""
    return sum(v for k, v in device_ms(fn).items() if name in k) or None


def _cudnn_lstm(dev, args, dtype):
    """torch.nn.LSTM(4H, H) on cuDNN computing the kernel's function on
    ``args`` (xproj, W, bias, h0, c0): W_ih = I, W_hh = W^T, b_ih = bias,
    b_hh = 0 (rounded to ``dtype``), plus the identity product's 2 T B
    (4H)^2 FLOPs; with its state."""
    import torch

    h = args[1].shape[0]
    lib = torch.nn.LSTM(4 * h, h, batch_first=True).to(dev, dtype)
    with torch.no_grad():
        lib.weight_ih_l0.copy_(torch.eye(4 * h, device=dev))
        lib.weight_hh_l0.copy_(args[1].t())
        lib.bias_ih_l0.copy_(args[2])
        lib.bias_hh_l0.zero_()
    return lib, (args[3][None].contiguous(), args[4][None].contiguous())


def _lstm_rows(what, dev, args, r_h, r_c, t, count, check, bf16=False):
    """The forward and the backward kernel at one shape: held against the
    plain versions (``check(name, got, want)`` per output), timed against
    them and cuDNN (forward: ``nn.LSTM``; backward: autograd of it, a
    cotangent on hs) in LSTM_ROUNDS alternating rounds, the earlier
    grid-barrier forward timed and checked beside, the kernels' device
    time from a profiled window.  Returns (forward _Sum, backward _Sum,
    extras of each)."""
    import torch

    from paddle_tpu_torch.kernels import lstm as klstm

    b, _, h = r_h.shape
    dt = args[0].dtype
    itemsize = 2 if bf16 else 4
    peak = PEAK_F32_FLOPS   # f32 products on the f32 master W
    got = klstm.lstm_seq(*args)
    fwd_launch = dict(klstm.last_launch)
    want = klstm.lstm_seq_plain(*args)
    err = max(check(f"lstm {n} {what}", g, w)
              for n, g, w in zip(("hs", "cs", "gates"), got, want))
    grid = klstm._launch_grid(*args)
    grid_err = max(check(f"lstm (grid design) {n} {what}", g, w)
                   for n, g, w in zip(("hs", "cs", "gates"), grid[:3], want))
    hs, cs, gates = got
    bwd_args = (gates, hs, cs, args[1], args[3], args[4], r_h, r_c)
    bwd = klstm.lstm_seq_bwd(*bwd_args)
    bwd_launch = dict(klstm.last_launch)
    want_bwd = klstm.lstm_seq_bwd_plain(*bwd_args)
    bwd_err = 0.0
    for n, g, w in zip(("dxproj", "dW", "dbias", "dh0", "dc0"), bwd,
                       want_bwd):
        bwd_err = max(bwd_err, check_bf16(f"lstm_bwd {n} {what}", g, w)
                      if w.dtype == torch.bfloat16 else
                      check_scaled(f"lstm_bwd {n} {what}", g, w,
                                   LSTM_GRAD_TOL))
    lib, state = _cudnn_lstm(dev, args, dt)
    x = args[0].detach().clone().requires_grad_(True)
    h0l, c0l = (s.detach().clone().requires_grad_(True) for s in state)
    with torch.no_grad():
        lib_err = float((lib(args[0], state)[0].float() - hs.float())
                        .abs().max())
        rounds = [(time_ms(lambda: klstm.lstm_seq(*args)),
                   time_ms(lambda: lib(args[0], state)))
                  for _ in range(LSTM_ROUNDS)]
        grid_ms = time_ms(lambda: klstm._launch_grid(*args))
        plain = time_ms(lambda: klstm.lstm_seq_plain(*args), reps=3)
        bwd_plain = time_ms(lambda: klstm.lstm_seq_bwd_plain(*bwd_args),
                            reps=3)
        kernel_bwd = time_ms(lambda: klstm._launch_bwd(
            gates, cs, args[4], args[1], r_h, r_c))
    out = lib(x, (h0l, c0l))[0]
    leaves = [x, h0l, c0l] + list(lib.parameters())
    bwd_rounds = [(time_ms(lambda: klstm.lstm_seq_bwd(*bwd_args)),
                   time_ms(lambda: torch.autograd.grad(
                       out, leaves, r_h, retain_graph=True)))
                  for _ in range(LSTM_ROUNDS)]
    del out
    dev_fwd = _kernel_device_ms(lambda: klstm.lstm_seq(*args),
                                "lstm_fwd_kernel")
    dev_grid = _kernel_device_ms(lambda: klstm._launch_grid(*args),
                                 "lstm_seq_kernel")
    dev_bwd = _kernel_device_ms(lambda: klstm.lstm_seq_bwd(*bwd_args),
                                "lstm_bwd_kernel")
    ms = statistics.median(r[0] for r in rounds)
    lib_ms = statistics.median(r[1] for r in rounds)
    bms = statistics.median(r[0] for r in bwd_rounds)
    lib_bms = statistics.median(r[1] for r in bwd_rounds)
    flops, nbytes = lstm_work(b, t, h, itemsize)
    _line(f"lstm {what} ({fwd_launch['tiles']} clusters of "
          f"{fwd_launch['cluster']} blocks, W "
          f"{'resident' if fwd_launch['resident'] else 'streamed'})", count,
          ms, plain, lib_ms, flops, nbytes, err, peak)
    log(f"  over {LSTM_ROUNDS} alternating rounds (median of 10 calls each): "
        f"kernel {min(r[0] for r in rounds):.4f}-"
        f"{max(r[0] for r in rounds):.4f} ms, cuDNN "
        f"{min(r[1] for r in rounds):.4f}-{max(r[1] for r in rounds):.4f} ms;"
        f" {1e3 * ms / t:.2f} us a step; device {dev_fwd} ms; the card holds "
        f"{fwd_launch['active_clusters']} such clusters at once; the grid "
        f"design {grid_ms:.4f} ms (device {dev_grid} ms, {grid[3]} blocks, "
        f"max err {grid_err:.2e}); cuDNN's hs vs the kernel's: max diff "
        f"{lib_err:.2e}")
    bflops, bbytes = lstm_bwd_work(b, t, h, itemsize)
    _line(f"lstm_bwd {what} ({bwd_launch['tiles']} clusters of "
          f"{bwd_launch['cluster']} blocks, W "
          f"{'resident' if bwd_launch['resident'] else 'streamed'})", count,
          bms, bwd_plain, lib_bms, bflops, bbytes, bwd_err, peak)
    log(f"  over {LSTM_ROUNDS} alternating rounds: backward "
        f"{min(r[0] for r in bwd_rounds):.4f}-"
        f"{max(r[0] for r in bwd_rounds):.4f} ms, autograd of cuDNN "
        f"{min(r[1] for r in bwd_rounds):.4f}-"
        f"{max(r[1] for r in bwd_rounds):.4f} ms; the kernel alone "
        f"{kernel_bwd:.4f} ms ({1e3 * kernel_bwd / t:.2f} us a step; bound "
        f"{bound(bflops / 2, 0, peak)[0]:.4f} ms), device {dev_bwd} ms; the "
        f"card holds {bwd_launch['active_clusters']} such clusters at once")
    fwd_sum, bwd_sum = _Sum(peak), _Sum(peak)
    fwd_sum.add(count, ms, plain, lib_ms, flops, nbytes, max(err, grid_err))
    bwd_sum.add(count, bms, bwd_plain, lib_bms, bflops, bbytes, bwd_err)
    fwd_extra = dict(grid_ms=grid_ms * count, device_ms=dev_fwd and
                     dev_fwd * count, grid_device_ms=dev_grid and
                     dev_grid * count, us_per_step=1e3 * ms / t,
                     clusters=fwd_launch["tiles"],
                     cluster_blocks=fwd_launch["cluster"],
                     resident=bool(fwd_launch["resident"]))
    bwd_extra = dict(kernel_ms=kernel_bwd * count, device_ms=dev_bwd and
                     dev_bwd * count, us_per_step=1e3 * kernel_bwd / t,
                     clusters=bwd_launch["tiles"],
                     cluster_blocks=bwd_launch["cluster"],
                     resident=bool(bwd_launch["resident"]))
    del lib
    return fwd_sum, bwd_sum, fwd_extra, bwd_extra


def phase_lstm_kernels(dev, randn):
    """The LSTM kernels (the forward's hs, cs, gates; the backward's
    dxproj, dW, dbias, dh0, dc0) against their plain versions, and
    LSTMSeq's backward against autograd of the plain forward, at the
    three benchmark/run.py widths (T 100, B 64, H 256, 512, 1280) and a
    ragged shape (T 7, B 5, H 100), all with non-zero h0/c0, xproj the
    (B, T, 4H) view of a projection; the earlier grid-barrier forward
    beside.  Library: torch.nn.LSTM(4H, H) on cuDNN (TF32 off) with W_ih
    = I, W_hh = W^T, b_ih = bias, b_hh = 0, the same function plus an
    identity product of 2 T B (4H)^2 FLOPs, and autograd of it.  The
    kernels line keeps H 256, the padded step's 2 + 2 launches."""
    import torch

    from paddle_tpu_torch.kernels import lstm as klstm

    def inputs(b, t, h):
        xp = randn(b * t, 4 * h, scale=0.5).reshape(b, t, 4 * h)
        return (xp, randn(h, 4 * h, scale=h ** -0.5), randn(4 * h, scale=0.1),
                randn(b, h, scale=0.5), randn(b, h, scale=0.5))

    def check(name, got, want):
        return check_close(name, got, want, **LSTM_TOL)

    def autograd_check(tag, args):
        r_h, r_c = randn(*args[0].shape[:2], args[1].shape[0]), randn(
            *args[0].shape[:2], args[1].shape[0])
        leaves = [a.detach().clone().requires_grad_(True) for a in args]
        torch.autograd.backward(klstm.LSTMSeq.apply(*leaves), [r_h, r_c])
        plain = [a.detach().clone().requires_grad_(True) for a in args]
        torch.autograd.backward(klstm.lstm_seq_plain(*plain)[:2], [r_h, r_c])
        for name, a, p in zip(("dxproj", "dW", "dbias", "dh0", "dc0"),
                              leaves, plain):
            check_scaled(f"LSTMSeq {name} {tag}", a.grad, p.grad,
                         LSTM_GRAD_TOL)
        return r_h, r_c

    args = inputs(5, 7, 100)
    r_h, r_c = autograd_check("T7 B5 H100", args)
    ragged = _lstm_rows("T7 B5 H100", dev, args, r_h, r_c, 7, 1, check)
    log(f"lstm at T 7, B 5, H 100 (h0, c0 non-zero): within {LSTM_TOL}; "
        f"LSTMSeq gradients and the backward kernel within {LSTM_GRAD_TOL} "
        f"x max of the plain versions")
    b, t = LSTM_BATCH, LSTM_SEQ
    results = {}
    for h in LSTM_WIDTHS:
        args = inputs(b, t, h)
        tag = f"T{t} B{b} H{h}"
        r_h, r_c = autograd_check(tag, args)
        count = 2 if h == LSTM_HIDDEN else 1
        fwd, bwd, fx, bx = _lstm_rows(tag, dev, args, r_h, r_c, t, count,
                                      check)
        if h == LSTM_HIDDEN:
            for s, rag in ((fwd, ragged[0]), (bwd, ragged[1])):
                s.max_abs_err = max(s.max_abs_err, rag.max_abs_err)
            results["lstm"] = {**fwd.result(), **fx}
            results["lstm_bwd"] = {**bwd.result(), **bx}
        del args
    torch.cuda.empty_cache()
    return results


def phase_lstm_bf16_kernel(dev, randn):
    """The bf16 LSTM instances (bf16 xproj view, h0, c0, gates, cs and
    cotangents; f32 W and bias; f32 carry) against their plain versions
    at the AMP step's T 100, B 64, H 256 and at T 7, B 5, H 100: the bf16
    outputs within the bf16 tolerance, the backward's f32 dW and dbias
    within LSTM_GRAD_TOL.  Library: torch.nn.LSTM in bf16 on cuDNN (W_ih
    = I, W_hh = W^T and b_ih = bias rounded to bf16, b_hh = 0) and
    autograd of it, timed with the kernels in LSTM_ROUNDS alternating
    rounds.  Bound: the recurrence's products at 67 TFLOP/s (f32 products,
    as the TPU kernel takes h W on the f32 master W), the bf16 and f32
    bytes at 3.35 TB/s."""
    import torch

    bf = torch.bfloat16

    def inputs(b, t, h):
        xp = randn(b * t, 8 * h, scale=0.5).to(bf).reshape(b, t, 8 * h)
        return (xp[:, :, 2 * h:6 * h], randn(h, 4 * h, scale=h ** -0.5),
                randn(4 * h, scale=0.1), randn(b, h, scale=0.5).to(bf),
                randn(b, h, scale=0.5).to(bf))

    def cot(b, t, h):
        return randn(b, t, h).to(bf), randn(b, t, h).to(bf)

    ragged = _lstm_rows("T7 B5 H100 bf16", dev, inputs(5, 7, 100),
                        *cot(5, 7, 100), 7, 1, check_bf16, bf16=True)
    b, t, h = LSTM_BATCH, LSTM_SEQ, LSTM_HIDDEN
    fwd, bwd, fx, bx = _lstm_rows(f"T{t} B{b} H{h} bf16", dev,
                                  inputs(b, t, h), *cot(b, t, h), t, 2,
                                  check_bf16, bf16=True)
    for s, rag in ((fwd, ragged[0]), (bwd, ragged[1])):
        s.max_abs_err = max(s.max_abs_err, rag.max_abs_err)
    torch.cuda.empty_cache()
    return {"lstm_bf16": {**fwd.result(), **fx},
            "lstm_bwd_bf16": {**bwd.result(), **bx}}


def lod_feed(rng, device=None):
    """Path B's feed: LOD_SEQS sequences of seeded lengths in 1..LOD_MAX_LEN,
    ids < LSTM_IDS as (N, 1) int64 with their offsets, labels (S, 1); on
    ``device`` as a LoDArray, else as numpy."""
    from paddle_tpu_torch.lod import create_lod_array

    lens = rng.randint(1, LOD_MAX_LEN + 1, LOD_SEQS)
    off = np.concatenate([[0], np.cumsum(lens)]).tolist()
    ids = rng.randint(0, LSTM_IDS, (off[-1], 1)).astype(np.int64)
    label = rng.randint(0, 2, (LOD_SEQS, 1)).astype(np.int64)
    if device is None:
        return {"ids": (ids, [off]), "label": label}
    import torch

    return {"ids": create_lod_array(torch.from_numpy(ids).to(device), [off]),
            "label": torch.from_numpy(label).to(device)}


def phase_gather_kernel(dev, randn):
    """The gather kernel against its plain version (exactly: a copy) on
    the 30000 x 512 table with path B's ids (int64 and int32), on a
    30000 x 510 table (the scalar path), and on a 9 x 5 table with ids
    out of range both ways (NaN rows, ids from the end).  Times at path
    B's shape; library: torch.index_select."""
    import torch

    from paddle_tpu_torch.kernels import embedding as kemb

    def same(tag, got, want):
        if not torch.equal(got.isnan(), want.isnan()) or not torch.equal(
                torch.nan_to_num(got), torch.nan_to_num(want)):
            fail(f"gather {tag}: kernel disagrees with its plain version")

    ids_np = lod_feed(np.random.RandomState(8))["ids"][0][:, 0]
    ids = torch.from_numpy(ids_np).to(dev)
    w = randn(LSTM_VOCAB, LSTM_EMB)
    for tag, table, idx in (("30000x512 int64", w, ids),
                            ("30000x512 int32", w, ids.int()),
                            ("30000x510", randn(LSTM_VOCAB, 510), ids)):
        same(tag, kemb.gather_rows(table, idx), kemb.gather_rows_plain(table, idx))
    small = randn(9, 5)
    odd = torch.tensor([0, 8, 9, -1, -9, -10, 100, 4], device=dev)
    got = kemb.gather_rows(small, odd)
    same("9x5 out of range", got, kemb.gather_rows_plain(small, odd))
    if not (got[[2, 5, 6]].isnan().all() and got[[0, 1, 3, 4, 7]].isfinite().all()):
        fail(f"gather: out-of-range ids do not give NaN rows: {got}")
    n, d = ids.shape[0], LSTM_EMB
    ms = time_ms(lambda: kemb.gather_rows(w, ids))
    plain = time_ms(lambda: kemb.gather_rows_plain(w, ids))
    lib = time_ms(lambda: torch.index_select(w, 0, ids))
    flops, nbytes = 0.0, 8.0 * n * d + 8.0 * n
    _line(f"gather {n} rows of 30000x{d}", 1, ms, plain, lib, flops, nbytes,
          0.0)
    log("  exact at every shape, NaN rows for ids outside [-V, V)")
    b_ms, b_by = bound(flops, nbytes)
    host = host_us(lambda: kemb.gather_rows(w, ids))
    lib_host = host_us(lambda: torch.index_select(w, 0, ids))
    cold = cold_device_ms(lambda: kemb.gather_rows(w, ids))
    lib_cold = cold_device_ms(lambda: torch.index_select(w, 0, ids))
    log(f"  gather: host {host:.2f} us a call (index_select {lib_host:.2f});"
        f" device time with the L2 flushed {cold:.4f} ms ({b_ms / cold:.3f} "
        f"of the bound; index_select {lib_cold:.4f} ms)")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=0.0, host_us=host,
                library_host_us=lib_host, cold_device_ms=cold,
                library_cold_device_ms=lib_cold, **_device_times(
                    "gather", ms, lib, lambda: kemb.gather_rows(w, ids),
                    lambda: torch.index_select(w, 0, ids)))


def build_lstm_program(seq=LSTM_SEQ, emb=LSTM_EMB, hidden=LSTM_HIDDEN,
                       seed=2026, optimizer=None):
    """Path A: lstm_text_classifier + Momentum(0.01, 0.9), as
    benchmark/run.py builds its `lstm` cell.  Returns (main, startup,
    pred, loss, params_grads)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import lstm_text_classifier

    pt.framework.reset_default_programs()
    main_prog = pt.default_main_program()
    startup = pt.default_startup_program()
    main_prog.seed = startup.seed = seed
    ids = pt.layers.data(name="ids", shape=[seq, 1], dtype="int64")
    label = pt.layers.data(name="label", shape=[1], dtype="int64")
    pred = lstm_text_classifier(ids, class_dim=2, emb_dim=emb, hidden=hidden)
    loss = pt.layers.mean(pt.layers.cross_entropy(input=pred, label=label))
    opt = optimizer or pt.optimizer.Momentum(learning_rate=0.01, momentum=0.9)
    _, params_grads = opt.minimize(loss)
    return main_prog, startup, pred, loss, params_grads


def build_lod_program(seed=2026):
    """Path B: LoD ids -> embedding([30000, 512]) -> fc(256, tanh) ->
    sequence_pool('average') -> fc(2, softmax) -> cross_entropy -> mean,
    Momentum(0.01, 0.9).  Returns (main, startup, loss, params_grads)."""
    import paddle_tpu_torch as pt

    pt.framework.reset_default_programs()
    main_prog = pt.default_main_program()
    startup = pt.default_startup_program()
    main_prog.seed = startup.seed = seed
    ids = pt.layers.data(name="ids", shape=[1], dtype="int64", lod_level=1)
    label = pt.layers.data(name="label", shape=[1], dtype="int64")
    emb = pt.layers.embedding(input=ids, size=[LSTM_VOCAB, LSTM_EMB])
    hid = pt.layers.fc(input=emb, size=LOD_FC, act="tanh")
    pooled = pt.layers.sequence_pool(hid, "average")
    pred = pt.layers.fc(input=pooled, size=2, act="softmax")
    loss = pt.layers.mean(pt.layers.cross_entropy(input=pred, label=label))
    _, params_grads = pt.optimizer.Momentum(
        learning_rate=0.01, momentum=0.9).minimize(loss)
    return main_prog, startup, loss, params_grads


def build_while_rnn(fl, n_seq=LOD_SEQS, vocab=LSTM_VOCAB, emb=LSTM_EMB,
                    hidden=LOD_FC, max_len=LOD_MAX_LEN, seed=2026):
    """Phase A's program, a dynamic RNN as the fluid book writes it, with
    the layers of package ``fl`` (the port, or in CPU tests the JAX
    package): LoD ids -> embedding -> lod_rank_table ->
    lod_tensor_to_array(max_len) -> While { array_read -> reshape,
    shrink_memory, fc([x_t, h], tanh), array_write, increment, less_than }
    -> array_to_lod_tensor -> sequence_pool('average') -> reshape ->
    fc(2, softmax).  ``n_seq`` sequences a batch (the memory and the output
    array are (n_seq, hidden)).  Returns (main, startup, rows, pooled,
    pred)."""
    fl.framework.reset_default_programs()
    main_prog = fl.default_main_program()
    startup = fl.default_startup_program()
    main_prog.seed = startup.seed = seed
    L = fl.layers
    ids = L.data(name="ids", shape=[1], dtype="int64", lod_level=1)
    x = L.embedding(input=ids, size=[vocab, emb])
    table = L.lod_rank_table(x)
    xs = L.lod_tensor_to_array(x, table, max_len=max_len)
    n = L.max_sequence_len(table)
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    h = L.fill_constant(shape=[n_seq, hidden], dtype="float32", value=0.0)
    hs = L.create_array("float32", elem_shape=[n_seq, hidden],
                        capacity=max_len)
    cond = L.less_than(i, n)
    loop = L.While(cond)
    with loop.block():
        x_t = L.reshape(L.array_read(xs, i), [-1, emb])
        h_prev = L.shrink_memory(h, i, table)
        h_t = L.fc(input=[x_t, h_prev], size=hidden, act="tanh")
        L.array_write(h_t, i, hs)
        L.assign(h_t, output=h)
        L.increment(i, value=1, in_place=True)
        L.assign(L.less_than(i, n), output=cond)
    rows = L.array_to_lod_tensor(hs, table)
    # the array's rows carry no static shape: the head's fc needs one
    pooled = L.reshape(L.sequence_pool(rows, "average"), [-1, hidden])
    pred = L.fc(input=pooled, size=2, act="softmax")
    return main_prog, startup, rows, pooled, pred


def build_ifelse_attention(fl, vocab=LSTM_VOCAB, emb=LSTM_EMB,
                           hidden=LOD_FC, lr=1e-3, seed=2026):
    """Phase B's program, an attention-pooling classifier with the layers
    of package ``fl``: LoD ids -> embedding -> fc(hidden, tanh) over the
    rows -> fc(1, no bias) -> sequence_softmax -> the rows weighted and summed per
    sequence (sequence_pool('sum')) -> an IfElse on aux < 0.5 per
    sequence with an fc(2) in each branch -> softmax_with_cross_entropy
    -> mean, Adam(lr).  Returns (main, startup, loss)."""
    fl.framework.reset_default_programs()
    main_prog = fl.default_main_program()
    startup = fl.default_startup_program()
    main_prog.seed = startup.seed = seed
    L = fl.layers
    ids = L.data(name="ids", shape=[1], dtype="int64", lod_level=1)
    aux = L.data(name="aux", shape=[1], dtype="float32")
    label = L.data(name="label", shape=[1], dtype="int64")
    x = L.embedding(input=ids, size=[vocab, emb])
    h = L.fc(input=x, size=hidden, act="tanh")
    # no bias on the score: a softmax ignores it, so its gradient is zero
    weights = L.sequence_softmax(L.fc(input=h, size=1, bias_attr=False))
    pooled = L.sequence_pool(L.elementwise_mul(h, weights), "sum")
    half = L.fill_constant_batch_size_like(aux, [-1, 1], "float32", 0.5)
    ie = L.IfElse(L.less_than(aux, half))
    with ie.true_block():
        ie.output(L.fc(input=pooled, size=2))
    with ie.false_block():
        ie.output(L.fc(input=pooled, size=2))
    (logits,) = ie()
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    fl.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main_prog, startup, loss


def attention_feed(rng, n_seq=LOD_SEQS, max_len=LOD_MAX_LEN,
                   vocab=LSTM_VOCAB, signal=16):
    """Phase B's batch as numpy: ``n_seq`` sequences of seeded lengths in
    1..max_len; label 1 for half of them, which carry ids below
    ``signal`` at about one step in five (the others never do), so the
    label is a function of the ids that the embedding and the attention
    can learn; aux uniform in [0, 1)."""
    lens = rng.randint(1, max_len + 1, n_seq)
    off = np.concatenate([[0], np.cumsum(lens)]).tolist()
    label = (np.arange(n_seq) % 2).astype(np.int64)
    rng.shuffle(label)
    ids = rng.randint(signal, vocab, off[-1])
    for s in np.flatnonzero(label):
        seg = slice(off[s], off[s + 1])
        hit = rng.rand(lens[s]) < 0.2
        hit[rng.randint(lens[s])] = True
        ids[seg] = np.where(hit, rng.randint(0, signal, lens[s]), ids[seg])
    return {"ids": (ids.astype(np.int64).reshape(-1, 1), [off]),
            "aux": rng.rand(n_seq, 1).astype(np.float32),
            "label": label.reshape(-1, 1)}


def seq_step_parity(dev, main_prog, startup, loss, params_grads, feed, what):
    """One step on the card against the same step on CPUPlace(), end to end
    and op by op.  End to end from identical weights and feeds: the loss
    within SEQ_PARITY_TOL of the CPU's largest magnitude; every gradient,
    parameter and velocity within max(SEQ_PARITY_TOL * max|CPU|,
    FLOOR_FACTOR * the spread of the CPU step with the embedding table
    perturbed by SEQ_PERTURB).  Op by op: every op on identical inputs
    within OP_TOL (the lstm grad ops get the forward's gates)."""
    import torch

    import paddle_tpu_torch as pt

    card = pt.Executor()
    scope = pt.Scope()
    card.run(startup, scope=scope)
    state = {n: v.cpu().numpy() for n, v in scope.values.items()}
    fetch = [loss.name] + [g.name for _, g in params_grads]
    names = fetch + sorted(state)
    t0 = time.perf_counter()
    got = card.run(main_prog, feed=feed, fetch_list=fetch, scope=scope)
    t_card = time.perf_counter() - t0
    got = [_host_dense(v) for v in got]
    got += [scope.get(n).cpu().numpy() for n in sorted(state)]
    del scope
    table = next(op for op in main_prog.global_block().ops
                 if op.type == "lookup_table").input("W")[0]
    runs = []
    t0 = time.perf_counter()
    for eps in (0.0, SEQ_PERTURB):
        cpu_scope = pt.Scope()
        cpu_scope.load_numpy(state, "cpu")
        emb = cpu_scope.get(table)
        emb.mul_(1 + eps * torch.randn(emb.shape, generator=torch.Generator()
                                       .manual_seed(3)))
        out = pt.Executor(pt.CPUPlace()).run(main_prog, feed=feed,
                                             fetch_list=fetch, scope=cpu_scope)
        runs.append([_host_dense(v) for v in out]
                    + [cpu_scope.get(n).numpy() for n in sorted(state)])
    t_cpu = (time.perf_counter() - t0) / 2
    params = {p.name for p, _ in params_grads}
    worst, floor_held, bad = {}, 0, []
    for i, name in enumerate(names):
        kind = ("loss" if name == loss.name else
                "gradient" if i < len(fetch) else
                "parameter" if name in params else
                "velocity" if "velocity" in name else "other state")
        want = np.asarray(runs[0][i], np.float64)
        g = np.asarray(got[i], np.float64)
        scale = float(np.abs(want).max()) if want.size else 0.0
        spread = float(np.abs(np.asarray(runs[1][i], np.float64)
                              - want).max())
        err = float(np.abs(g - want).max()) if np.isfinite(g).all() else np.inf
        allowed = SEQ_PARITY_TOL * scale
        if kind != "loss":
            floor_held += FLOOR_FACTOR * spread > allowed
            allowed = max(allowed, FLOOR_FACTOR * spread)
        rel, rel_spread = (err / scale, spread / scale) if scale else (err,
                                                                       spread)
        if rel > worst.get(kind, (-1.0,))[0]:
            worst[kind] = (rel, rel_spread, name)
        if not err <= allowed:
            bad.append((name, err, allowed))
    log(f"{what}, end to end (card {t_card:.2f} s, CPU plain path "
        f"{t_cpu:.2f} s per step): loss card {float(got[0]):.6f} vs CPU "
        f"{float(runs[0][0]):.6f}; {len(params_grads)} gradients and "
        f"{len(state)} state tensors, {floor_held} of them held to "
        f"{FLOOR_FACTOR} x the CPU's own spread under a {SEQ_PERTURB} "
        "perturbation of the embedding table; worst max|card - CPU| / "
        f"max|CPU| per kind (the CPU's spread beside it; tolerance "
        f"{SEQ_PARITY_TOL}):")
    for kind, (rel, rel_spread, name) in sorted(worst.items()):
        log(f"  {kind}: {rel:.3e} (spread {rel_spread:.3e}; {name})")
    if bad:
        fail(f"{what}: the card differs from the CPU end to end: {bad[:10]}")
    del got, runs
    ops_on_identical_inputs(dev, main_prog.global_block(), state, feed, what)


def phase_lstm_parity(dev, amp=False):
    """Path A at full width, B 2: card vs CPU (under AMP with ``amp``:
    amp_step_parity)."""
    main_prog, startup, _, loss, params_grads = build_lstm_program()
    rng = np.random.RandomState(9)
    feed = {"ids": rng.randint(0, LSTM_IDS, (LSTM_PARITY_BATCH, LSTM_SEQ, 1))
            .astype(np.int64),
            "label": rng.randint(0, 2, (LSTM_PARITY_BATCH, 1)).astype(np.int64)}
    what = (f"LSTM classifier step parity at full width, B "
            f"{LSTM_PARITY_BATCH} T {LSTM_SEQ}")
    if amp:
        amp_step_parity(dev, main_prog, startup, loss, params_grads, feed,
                        what)
    else:
        seq_step_parity(dev, main_prog, startup, loss, params_grads, feed,
                        what)


def seq_train_step(dev, main_prog, startup, loss, feed, expect, what, smi,
                   amp=False):
    """A step of a sequence path on the card (under AMP with ``amp``): the
    counters zeroed just before the first step and read just after must
    equal ``expect``; then 5 timed steps after 2 warm-up steps and peak
    memory.  Returns (seconds of the 5 steps, peak bytes, launches, the
    launches on the wgmma engine)."""
    import torch

    import paddle_tpu_torch as pt

    want = dict.fromkeys(KERNELS, 0)
    want.update(expect)
    if launches_implied(main_prog, amp) != want:
        fail(f"{what}: the program implies "
             f"{launches_implied(main_prog, amp)}, not {want}")
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    t0 = time.perf_counter()
    (first,) = exe.run(main_prog, feed=feed, fetch_list=[loss], scope=scope)
    first_s = time.perf_counter() - t0
    launches = counters()
    wgmma = wgmma_counters()
    log(f"{what}: first step loss {float(first):.5f} in {first_s:.2f} s; "
        f"launches {launches}; on the wgmma engine {wgmma}")
    if launches != want:
        fail(f"{what}: launch counts {launches} != {want}")
    (second,) = exe.run(main_prog, feed=feed, fetch_list=[loss], scope=scope)
    times, losses = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        (val,) = exe.run(main_prog, feed=feed, fetch_list=[loss], scope=scope)
        times.append(time.perf_counter() - t0)   # numpy fetch: a device sync
        losses.append(float(val))
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite([float(first), float(second)] + losses)):
        fail(f"{what}: non-finite loss: {first}, {second}, {losses}")
    log(f"{what}: 5 timed steps after 2 warm-up steps {sum(times):.4f} s "
        f"(median {statistics.median(times) * 1e3:.2f} ms, min "
        f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}); losses "
        f"{[round(x, 5) for x in losses]}; peak memory allocated "
        f"{peak / 2**30:.3f} GiB on {smi}")
    del exe, scope
    torch.cuda.empty_cache()
    return sum(times), peak, launches, wgmma


def lstm_step_feed(dev):
    """Path A's step feed, B 64 T 100, made on the card from a seed."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(13)
    return {"ids": torch.randint(0, LSTM_IDS, (LSTM_BATCH, LSTM_SEQ, 1),
                                 device=dev, generator=gen),
            "label": torch.randint(0, 2, (LSTM_BATCH, 1), device=dev,
                                   generator=gen)}


def phase_lstm_train_step(dev, smi, amp=False):
    """Path A at full width, B 64 T 100: launches 2 lstm / 2 lstm backward
    / 3 matmul / 1 softmax / 0 gather (under AMP with ``amp``: 2 bf16 lstm
    / 2 bf16 lstm backward / 3 bf16 matmul / 1 f32 softmax, no f32 lstm or
    matmul launch), samples/s and tokens/s, peak memory."""
    import paddle_tpu_torch as pt

    main_prog, startup, _, loss, _ = build_lstm_program()
    b, t = LSTM_BATCH, LSTM_SEQ
    kind = "AMP bf16" if amp else "f32"
    sfx = "_bf16" if amp else ""
    with pt.amp.amp_guard(amp):
        secs, peak, launches, wgmma = seq_train_step(
            dev, main_prog, startup, loss, lstm_step_feed(dev),
            {f"lstm{sfx}": 2, f"lstm_bwd{sfx}": 2, f"matmul{sfx}": 3,
             "softmax": 1, "embedding": 0},
            f"LSTM classifier step at B {b} T {t} ({kind})", smi, amp)
    sps = 5 * b / secs
    log(f"LSTM classifier step ({kind}): {sps:.1f} samples/s, "
        f"{sps * t:.1f} tokens/s ({1e3 * secs / 5:.2f} ms per step) on "
        f"{smi}")
    return dict(samples_per_s=sps, tokens_per_s=sps * t, peak_bytes=peak,
                launches=launches, wgmma=wgmma)


def token_task(rng, batch, seq, vocab):
    """A seeded separable task: label 1 iff token 0 occurs (placed at a
    random step in half the rows; the others draw from 1..vocab-1)."""
    ids = rng.randint(1, vocab, (batch, seq, 1)).astype(np.int64)
    label = rng.randint(0, 2, batch)
    for i in np.nonzero(label)[0]:
        ids[i, rng.randint(0, seq), 0] = 0
    return {"ids": ids, "label": label.reshape(-1, 1).astype(np.int64)}


def phase_lstm_converge(dev, amp=False):
    """lstm_text_classifier at small widths (T 20, emb 32, hidden 64)
    learns token_task on the card with Adam(1e-2), 200 steps of 32, under
    AMP with ``amp``: held-out accuracy over 256 rows must pass
    SEQ_CONVERGE_ACC."""
    import paddle_tpu_torch as pt

    with pt.amp.amp_guard(amp):
        _lstm_converge("AMP bf16" if amp else "f32")


def _lstm_converge(kind):
    import paddle_tpu_torch as pt

    seq, vocab = 20, 50
    main_prog, startup, pred, loss, _ = build_lstm_program(
        seq=seq, emb=32, hidden=64, seed=7,
        optimizer=pt.optimizer.Adam(learning_rate=1e-2))
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(44)
    t0 = time.perf_counter()
    losses = []
    for _ in range(200):
        (lv,) = exe.run(main_prog, feed=token_task(rng, 32, seq, vocab),
                        fetch_list=[loss], scope=scope)
        losses.append(float(lv))
    test = main_prog.clone(for_test=True)
    held = token_task(rng, 256, seq, vocab)
    (probs,) = exe.run(test, feed=held, fetch_list=[pred], scope=scope)
    acc = float((probs.argmax(1) == held["label"][:, 0]).mean())
    log(f"small LSTM classifier + Adam ({kind}), 200 steps of 32 x {seq} "
        f"tokens on {exe.place!r} in {time.perf_counter() - t0:.2f} s: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, held-out accuracy {acc:.3f}")
    if not acc > SEQ_CONVERGE_ACC:
        fail(f"the small LSTM classifier ({kind}) did not learn the task: "
             f"accuracy {acc:.3f} <= {SEQ_CONVERGE_ACC}")


def phase_lod_parity(dev):
    """Path B at its full size (64 sequences, about 3.2 k rows): card vs
    CPU."""
    main_prog, startup, loss, params_grads = build_lod_program()
    feed = lod_feed(np.random.RandomState(10))
    seq_step_parity(dev, main_prog, startup, loss, params_grads, feed,
                    f"LoD classifier step parity, {LOD_SEQS} sequences of "
                    f"{feed['ids'][1][0][-1]} rows")


def phase_lod_train_step(dev, smi):
    """Path B: launches 1 gather / 2 matmul / 1 softmax / 0 lstm, steps/s,
    rows/s, peak memory."""
    main_prog, startup, loss, _ = build_lod_program()
    feed = lod_feed(np.random.RandomState(8), dev)
    rows = int(feed["ids"].data.shape[0])
    secs, peak, launches, wgmma = seq_train_step(
        dev, main_prog, startup, loss, feed,
        dict(embedding=1, matmul=2, softmax=1, lstm=0),
        f"LoD classifier step, {LOD_SEQS} sequences of {rows} rows (f32)",
        smi)
    log(f"LoD classifier step: {5 / secs:.2f} steps/s, {5 * rows / secs:.1f}"
        f" rows/s ({1e3 * secs / 5:.2f} ms per step) on {smi}")
    return dict(steps_per_s=5 / secs, rows_per_s=5 * rows / secs,
                peak_bytes=peak, launches=launches, wgmma=wgmma)


# ---------------------------------------------------------------------------
# phases 15a-15d: the wide_deep cell of benchmark/run.py
# ---------------------------------------------------------------------------


def build_wide_deep_program(seed=2026):
    """models.wide_deep + mean(log_loss) + Adam(1e-3), as
    benchmark/run.py's bench_wide_deep builds it (sparse tables).  Returns
    (main, startup, loss, params_grads)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import wide_deep

    pt.framework.reset_default_programs()
    main_prog = pt.default_main_program()
    startup = pt.default_startup_program()
    main_prog.seed = startup.seed = seed
    wide = pt.layers.data(name="wide", shape=[WD_WIDE_IDS, 1], dtype="int64")
    deep = pt.layers.data(name="deep", shape=[WD_FIELDS, 1], dtype="int64")
    label = pt.layers.data(name="label", shape=[1], dtype="float32")
    prob = wide_deep(wide, deep, wide_vocab=WD_WIDE_VOCAB,
                     deep_vocab=WD_DEEP_VOCAB, num_fields=WD_FIELDS,
                     emb_dim=WD_EMB, hidden=WD_HIDDEN, is_sparse=True)
    loss = pt.layers.mean(pt.layers.log_loss(prob, label))
    _, params_grads = pt.optimizer.Adam(learning_rate=WD_LR).minimize(loss)
    return main_prog, startup, loss, params_grads


def wide_deep_feed(batch, seed=0, device=None):
    """The feed as benchmark/run.py:354-360 draws it (numpy RandomState,
    seed 0 there), as tensors on ``device`` when given."""
    import torch

    rng = np.random.RandomState(seed)
    feed = {"wide": rng.randint(0, WD_WIDE_VOCAB, (batch, WD_WIDE_IDS, 1))
            .astype(np.int64),
            "deep": rng.randint(0, WD_DEEP_VOCAB, (batch, WD_FIELDS, 1))
            .astype(np.int64),
            "label": (rng.rand(batch, 1) < 0.3).astype(np.float32)}
    if device is not None:
        feed = {k: torch.from_numpy(v).to(device) for k, v in feed.items()}
    return feed


def wide_deep_engines(bf16):
    """{(m, k, n): engine} of the deep tower's three products at B 1024:
    the 416 x 256 and 256 x 128 layers on a wgmma engine, the N 1 head on
    the SIMT (f32) or mma.sync (bf16) tile."""
    shapes = mul_shapes_of(build_wide_deep_program()[0], WD_BATCH)
    small = "mma.sync" if bf16 else "simt"
    return {s: "wgmma" if s[2] > 1 else small for s in shapes}


def phase_wide_deep_dense(dev, randn):
    """The matmul kernel against its plain version at the wide_deep step's
    three forward products (B 1024, from its program), in f32 and in bf16
    (its AMP step), each on the engine its rule picks, which must be the
    one ``wide_deep_engines`` names.  Logged, with the summed row of each
    step; the kernels line keeps the transformer's numbers."""
    import torch

    from paddle_tpu_torch.kernels import matmul as kmatmul

    out = {}
    for bf16 in (False, True):
        dt = torch.bfloat16 if bf16 else torch.float32
        peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
        rule = kmatmul.bf16_engine if bf16 else kmatmul.f32_engine
        check = check_bf16 if bf16 else (
            lambda n, g, w: check_close(n, g, w, **GEMM_TOL))
        kind = "bf16" if bf16 else "f32"
        sm = _Sum(peak)
        log(f"{kind} matmul at the wide_deep step's forward shapes (B "
            f"{WD_BATCH}), per call:")
        for (m, k, n), engine in wide_deep_engines(bf16).items():
            x = randn(m, k).to(dt)
            y = randn(k, n, scale=k ** -0.5).to(dt)
            got = rule(m, k, n, x.data_ptr(), y.data_ptr())
            if got != engine:
                fail(f"wide_deep {kind} matmul {m}x{k}x{n}: engine {got}, "
                     f"not {engine}")
            err = check(f"wide_deep {kind} matmul {m}x{k}x{n}",
                        kmatmul.matmul(x, y), kmatmul.matmul_plain(x, y))
            times = (time_ms(lambda: kmatmul.matmul(x, y)),
                     time_ms(lambda: kmatmul.matmul_plain(x, y)),
                     time_ms(lambda: torch.matmul(x, y)))
            flops = 2.0 * m * k * n
            nbytes = x.element_size() * (m * k + k * n + m * n)
            _line(f"{m}x{k}x{n} ({engine} engine)", 1, *times, flops, nbytes,
                  err, peak)
            sm.add(1, *times, flops, nbytes, err)
        r = out[kind] = sm.result()
        log(f"  the wide_deep {kind} step's 3 forward products: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); max err {r['max_abs_err']:.2e}")
    return out


def _host_dense(v):
    """A fetched value as a dense numpy array: a SparseGrad's rows added
    into its height on the host (the comparison's copy, not the path's)."""
    from paddle_tpu_torch.sparse import SparseGrad

    if not isinstance(v, SparseGrad):
        return v
    dense = np.zeros(v.shape, np.float64)
    np.add.at(dense, np.asarray(v.rows), np.asarray(v.values, np.float64))
    return dense


def _sparse_on_card(dev, main_prog, startup, loss, feed, amp):
    """One step on the card from a fresh start, fetching both tables'
    W@GRAD as tensors: each must be a SparseGrad of the batch's B x 26
    rows on the card, and no SparseGrad may be densified during the step
    (``SparseGrad.to_dense`` counted).  Then the sparse Adam update of
    wide_w alone, under ``torch.cuda.set_sync_debug_mode("error")``: no
    device-to-host sync."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import sparse
    from paddle_tpu_torch.registry import LowerContext, OpRegistry

    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    dense_calls = []
    to_dense = sparse.SparseGrad.to_dense
    sparse.SparseGrad.to_dense = lambda self: (dense_calls.append(1),
                                               to_dense(self))[1]
    try:
        with pt.amp.amp_guard(amp):
            grads = exe.run(main_prog, feed=feed,
                            fetch_list=[loss.name, "wide_w@GRAD",
                                        "deep_emb@GRAD"],
                            scope=scope, return_numpy=False)[1:]
    finally:
        sparse.SparseGrad.to_dense = to_dense
    rows = feed["wide"].shape[0] * WD_FIELDS
    for name, g, width in zip(("wide_w", "deep_emb"), grads, (1, WD_EMB)):
        if not (isinstance(g, sparse.SparseGrad)
                and g.values.device.type == "cuda"
                and tuple(g.values.shape) == (rows, width)
                and g.values.dtype == torch.float32):
            fail(f"wide_deep: {name}@GRAD on the card is {g!r}, not a "
                 f"float32 SparseGrad of {rows} rows")
    if dense_calls:
        fail(f"wide_deep: the step densified a SparseGrad "
             f"{len(dense_calls)} times")
    op = next(o for o in main_prog.global_block().ops
              if o.type == "adam" and o.input("Param") == ["wide_w"])
    values = {n: scope.get(n) for n in op.input_arg_names
              if n != "wide_w@GRAD"}
    values["wide_w@GRAD"] = grads[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        OpRegistry.get("adam").lower(LowerContext(op, values, dev))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"wide_deep {'AMP ' if amp else ''}step on the card: wide_w@GRAD and "
        f"deep_emb@GRAD are SparseGrads of {rows} rows (no (vocab, D) "
        "gradient built, no SparseGrad densified); the sparse Adam update "
        "ran with no device-to-host sync")
    del exe, scope


def phase_wide_deep_parity(dev, amp=False):
    """Phase 15a (f32) / 15c (AMP): the cell at full width, B
    WD_PARITY_BATCH, one step on the card against CPUPlace() from
    identical weights, end to end and op by op (seq_step_parity /
    amp_step_parity: the loss, both tables' gradients, every parameter and
    Adam moment after the update), then the sparse checks on the card
    (``_sparse_on_card``)."""
    main_prog, startup, loss, params_grads = build_wide_deep_program()
    feed = wide_deep_feed(WD_PARITY_BATCH, seed=9)
    what = (f"wide_deep step parity at full width, B {WD_PARITY_BATCH}")
    if amp:
        amp_step_parity(dev, main_prog, startup, loss, params_grads, feed,
                        what)
    else:
        seq_step_parity(dev, main_prog, startup, loss, params_grads, feed,
                        what)
    _sparse_on_card(dev, main_prog, startup, loss, feed, amp)


def phase_wide_deep_step(dev, smi, amp=False):
    """Phase 15b (f32) / 15d (AMP): the cell at run.py's size, B 1024,
    the feed as run.py draws it.  The counters zeroed just before the
    first step and read just after: 3 matmul launches (bf16 under AMP),
    2 of them on the wgmma engine, nothing else; examples/s and ms a step
    over WD_TIMED steps after WD_WARMUP warm-up steps, peak memory; after
    them the rows no id of the feed touched hold their initial values
    bit for bit and zero Adam moments (lazy rows)."""
    import torch

    import paddle_tpu_torch as pt

    kind = "AMP bf16" if amp else "f32"
    mm = "matmul_bf16" if amp else "matmul"
    main_prog, startup, loss, _ = build_wide_deep_program()
    want = dict.fromkeys(KERNELS, 0)
    want[mm] = 3
    if launches_implied(main_prog, amp) != want:
        fail(f"wide_deep {kind}: the program implies "
             f"{launches_implied(main_prog, amp)}, not {want}")
    want_wgmma = dict.fromkeys(wgmma_counters(), 0)
    want_wgmma[mm] = 2
    feed = wide_deep_feed(WD_BATCH, device=dev)
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    start = {n: scope.get(n).clone() for n in ("wide_w", "deep_emb")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with pt.amp.amp_guard(amp):
        zero_counters()
        t0 = time.perf_counter()
        (first,) = exe.run(main_prog, feed=feed, fetch_list=[loss],
                           scope=scope)
        first_s = time.perf_counter() - t0
        launches, wgmma = counters(), wgmma_counters()
        log(f"wide_deep {kind} step at B {WD_BATCH}: first step loss "
            f"{float(first):.5f} in {first_s:.2f} s; launches "
            f"{ {k: v for k, v in launches.items() if v} }, on the wgmma "
            f"engine { {k: v for k, v in wgmma.items() if v} }")
        if launches != want:
            fail(f"wide_deep {kind}: launch counts {launches} != {want}")
        if wgmma != want_wgmma:
            fail(f"wide_deep {kind}: wgmma launch counts {wgmma} != "
                 f"{want_wgmma}")
        losses = [float(first)]
        for _ in range(WD_WARMUP - 1):
            losses += [float(v) for v in exe.run(
                main_prog, feed=feed, fetch_list=[loss], scope=scope)]
        times = []
        for _ in range(WD_TIMED):
            t0 = time.perf_counter()
            (val,) = exe.run(main_prog, feed=feed, fetch_list=[loss],
                             scope=scope)
            times.append(time.perf_counter() - t0)   # numpy fetch: a sync
            losses.append(float(val))
    peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fail(f"wide_deep {kind}: losses {losses} (non-finite, or the same "
             "batch's loss did not fall)")
    for table, slot in (("wide_w", "wide"), ("deep_emb", "deep")):
        idle = torch.ones(start[table].shape[0], dtype=torch.bool, device=dev)
        idle[feed[slot].reshape(-1)] = False
        after = scope.get(table)
        if not torch.equal(after[idle], start[table][idle]):
            fail(f"wide_deep {kind}: rows of {table} no id touched moved")
        if torch.equal(after[~idle], start[table][~idle]):
            fail(f"wide_deep {kind}: the touched rows of {table} did not move")
        for m in (n for n in scope.keys() if n.startswith(table + "_moment")):
            if scope.get(m)[idle].any():
                fail(f"wide_deep {kind}: {m} is not zero on untouched rows")
        log(f"  {table}: {int(idle.sum())} of {idle.numel()} rows untouched by "
            f"the feed, bit for bit unchanged after {len(losses)} steps, Adam "
            "moments zero there")
    ex_s = WD_TIMED * WD_BATCH / sum(times)
    ms = statistics.median(times) * 1e3
    log(f"wide_deep train step at B {WD_BATCH} ({kind}): {ex_s:.1f} "
        f"examples/s over {WD_TIMED} timed steps after {WD_WARMUP} warm-up "
        f"steps ({sum(times):.4f} s; median {ms:.3f} ms, min "
        f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}); losses "
        f"{[round(x, 5) for x in losses]}; peak memory allocated "
        f"{peak / 2**30:.3f} GiB on {smi}")
    del exe, scope
    torch.cuda.empty_cache()
    return dict(examples_per_s=ex_s, ms_per_step=ms, peak_bytes=peak,
                launches=launches, wgmma=wgmma)


# ---------------------------------------------------------------------------
# the seq2seq cell of benchmark/run.py
# ---------------------------------------------------------------------------


def seq2seq_config(tch, vocab=S2S_VOCAB, emb=S2S_EMB, hid=S2S_HID,
                   batch=S2S_BATCH):
    """benchmark/run.py:175-216's v1 config function, written against
    the port's trainer_config_helpers (``tch``)."""

    def config():
        tch.settings(batch_size=batch, learning_rate=1e-3,
                     learning_method=tch.AdamOptimizer())
        src = tch.data_layer(name="src", size=vocab)
        src_emb = tch.embedding_layer(input=src, size=emb,
                                      param_attr=tch.ParamAttr(name="src_emb"))
        enc_proj = tch.fc_layer(input=src_emb, size=3 * hid,
                                act=tch.LinearActivation(), bias_attr=False)
        enc = tch.grumemory(input=enc_proj, size=hid, name="enc_seq")
        trg_in = tch.data_layer(name="trg_in", size=vocab)
        trg_out = tch.data_layer(name="trg_out", size=vocab)
        trg_emb = tch.embedding_layer(input=trg_in, size=emb,
                                      param_attr=tch.ParamAttr(name="trg_emb"))

        def step(word, enc_states):
            dec_mem = tch.memory(name="dec_state", size=hid)
            ctx = tch.simple_attention(encoded_sequence=enc_states,
                                       encoded_proj=enc_states,
                                       decoder_state=dec_mem)
            inp = tch.fc_layer(input=[word, ctx], size=3 * hid,
                               act=tch.LinearActivation(), bias_attr=False)
            dec = tch.gru_step_layer(input=inp, output_mem=dec_mem, size=hid,
                                     name="dec_state")
            return tch.fc_layer(input=dec, size=vocab,
                                act=tch.SoftmaxActivation())

        probs = tch.recurrent_group(
            step=step, input=[trg_emb, tch.StaticInput(enc, is_seq=True,
                                                       size=hid)])
        tch.outputs(tch.classification_cost(input=probs, label=trg_out))

    return config


def seq2seq_trainer(place=None, batch=S2S_BATCH):
    """parse_config(the cell's config) -> Trainer, as run.py:218-224 does:
    the data layers typed integer_value_sequence(VOCAB), the Trainer (its
    Parameters and SGD's Executors) on ``place``, CUDAPlace(0) unless
    given."""
    import paddle_tpu_torch.trainer_config_helpers as tch
    from paddle_tpu_torch.trainer.config_parser import parse_config
    from paddle_tpu_torch.trainer.trainer import Trainer
    from paddle_tpu_torch.v2.data_type import integer_value_sequence

    conf = parse_config(seq2seq_config(tch, batch=batch))
    for name in ("src", "trg_in", "trg_out"):
        conf.data_layers[name].input_type = integer_value_sequence(S2S_VOCAB)
    return Trainer(conf, place)


def seq2seq_feed(batch, seq, seed=0, ragged=False, device=None):
    """run.py:226-236's six feeds (ids in [2, VOCAB), full lengths), or
    ragged lengths in [1, seq] with a full one in each; as tensors on
    ``device`` when given (run.py stages them on the device)."""
    import torch

    rng = np.random.RandomState(seed)
    src = rng.randint(2, S2S_VOCAB, (batch, seq)).astype(np.int64)
    trg_in = rng.randint(2, S2S_VOCAB, (batch, seq)).astype(np.int64)
    trg_out = rng.randint(2, S2S_VOCAB, (batch, seq)).astype(np.int64)
    src_len = np.full((batch,), seq, np.int32)
    trg_len = np.full((batch,), seq, np.int32)
    if ragged:
        src_len = rng.randint(1, seq + 1, batch).astype(np.int32)
        trg_len = rng.randint(1, seq + 1, batch).astype(np.int32)
        src_len[0] = trg_len[-1] = seq
    feed = {"src": src, "src@len": src_len, "trg_in": trg_in,
            "trg_in@len": trg_len, "trg_out": trg_out,
            "trg_out@len": trg_len}
    if device is not None:
        feed = {k: torch.from_numpy(v).to(device) for k, v in feed.items()}
    return feed


def seq2seq_parts(trainer):
    """(main program, startup, cost var, params_grads, the step block's
    parameters) of a Trainer's topology."""
    from paddle_tpu_torch.analysis import dataflow

    topo = trainer._sgd.topology
    prog = topo.main_program
    block = prog.global_block()
    params_grads = [(p, block.var(p.name + "@GRAD"))
                    for p in prog.all_parameters()]
    rnn = next(op for op in block.ops if op.type == "recurrent")
    step_params = sorted(n for n in dataflow.sub_block_external_reads(rnn)
                         if n in {p.name for p, _ in params_grads})
    return prog, topo.startup_program, topo.cost_var, params_grads, step_params


def seq2seq_matmul_shapes(steps=S2S_SEQ, batch=S2S_BATCH):
    """{(m, k, n): launches} of the matmul kernel in one step of the cell
    (source and target ``steps`` long): the encoder's 3H projection and
    the hoisted vocab projection at B x S rows, and a time step's
    attention score (B x S rows, N 1) and two input projections (B rows),
    S times in the forward and S times again in recurrent_grad's
    replay."""
    rows = batch * steps
    shapes = {}
    for shape, count in (((rows, S2S_EMB, 3 * S2S_HID), 1),
                         ((rows, S2S_HID, S2S_VOCAB), 1),
                         ((rows, S2S_HID, 1), 2 * steps),
                         ((batch, S2S_EMB, 3 * S2S_HID), 2 * steps),
                         ((batch, S2S_HID, 3 * S2S_HID), 2 * steps)):
        shapes[shape] = shapes.get(shape, 0) + count
    return shapes


def phase_seq2seq_dense(dev, randn):
    """The matmul kernel at the seq2seq step's five product shapes (B 64,
    S 32) in f32 and bf16 (its AMP step), each on the engine its rule
    picks (the N 1 attention score's included), summed over the step's
    194 launches; the softmax kernel over the 2048 x 30000 of its
    probabilities (which the step itself runs through torch.softmax, as
    the JAX op does: they are 3-D).  Logged (the kernels line keeps the transformer's
    matmul and ResNet's softmax numbers)."""
    import torch

    from paddle_tpu_torch.kernels import matmul as kmatmul
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    out = {}
    for bf16 in (False, True):
        dt = torch.bfloat16 if bf16 else torch.float32
        peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
        rule = kmatmul.bf16_engine if bf16 else kmatmul.f32_engine
        check = check_bf16 if bf16 else (
            lambda n, g, w: check_close(n, g, w, **GEMM_TOL))
        kind = "bf16" if bf16 else "f32"
        sm, engines = _Sum(peak), {}
        # f32 on the wgmma engine is split TF32: 3 x FLOPs at its peak
        bound_tf32 = 0.0
        log(f"{kind} matmul at the seq2seq step's shapes (B {S2S_BATCH}, S "
            f"{S2S_SEQ}), per call:")
        for (m, k, n), count in seq2seq_matmul_shapes().items():
            x = randn(m, k).to(dt)
            y = randn(k, n, scale=k ** -0.5).to(dt)
            engine = rule(m, k, n, x.data_ptr(), y.data_ptr())
            engines[engine] = engines.get(engine, 0) + count
            before = kmatmul.launches_bf16_wgmma if bf16 \
                else kmatmul.launches_wgmma
            err = check(f"seq2seq {kind} matmul {m}x{k}x{n}",
                        kmatmul.matmul(x, y), kmatmul.matmul_plain(x, y))
            after = kmatmul.launches_bf16_wgmma if bf16 \
                else kmatmul.launches_wgmma
            if (after - before == 1) != (engine == "wgmma"):
                fail(f"seq2seq {kind} matmul {m}x{k}x{n}: the rule says "
                     f"{engine}, the launch counters disagree")
            times = (time_ms(lambda: kmatmul.matmul(x, y)),
                     time_ms(lambda: kmatmul.matmul_plain(x, y), reps=3),
                     time_ms(lambda: torch.matmul(x, y)))
            flops = 2.0 * m * k * n
            nbytes = x.element_size() * (m * k + k * n + m * n)
            _line(f"{m}x{k}x{n} ({engine} engine)", count, *times, flops,
                  nbytes, err, peak)
            sm.add(count, *times, flops, nbytes, err)
            if not bf16 and engine == "wgmma":
                b_tf32 = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)[0]
                log(f"    as split TF32 (3 x FLOPs at "
                    f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s): bound "
                    f"{b_tf32:.4f} ms, the kernel at "
                    f"{b_tf32 / times[0]:.2f} of it")
                bound_tf32 += count * b_tf32
            elif not bf16:
                bound_tf32 += count * bound(flops, nbytes, peak)[0]
        r = out[kind] = sm.result()
        r["engines"] = engines
        if not bf16:
            r["bound_tf32_ms"] = bound_tf32
        log(f"  the seq2seq {kind} step's {sum(engines.values())} matmul "
            f"launches ({engines}): kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
            + ("" if bf16 else f", {bound_tf32:.4f} ms with the wgmma "
               "shapes as split TF32")
            + f"; max err {r['max_abs_err']:.2e}")
    x = randn(S2S_BATCH * S2S_SEQ, S2S_VOCAB, scale=4.0)
    err = check_close(f"softmax {tuple(x.shape)}", ksoftmax.softmax(x),
                      ksoftmax.softmax_plain(x), rtol=0, atol=SOFTMAX_ATOL)
    times = (time_ms(lambda: ksoftmax.softmax(x)),
             time_ms(lambda: ksoftmax.softmax_plain(x)),
             time_ms(lambda: torch.softmax(x, dim=-1)))
    dev_ms = sum(device_ms(lambda: ksoftmax.softmax(x)).values())
    lib_dev_ms = sum(device_ms(lambda: torch.softmax(x, dim=-1)).values())
    _line(f"softmax {S2S_BATCH * S2S_SEQ}x{S2S_VOCAB}", 1, *times,
          5.0 * x.numel(), 8.0 * x.numel(), err)
    b_ms, b_by = bound(5.0 * x.numel(), 8.0 * x.numel())
    log(f"  (tolerance atol {SOFTMAX_ATOL}); device {dev_ms:.4f} ms, "
        f"torch.softmax device {lib_dev_ms:.4f} ms")
    out["softmax"] = dict(ms=times[0], plain_ms=times[1],
                          library_ms=times[2], bound_ms=b_ms, bound_by=b_by,
                          max_abs_err=err, device_ms=dev_ms,
                          library_device_ms=lib_dev_ms)
    return out


def _seq2seq_step_block_grads(dev, trainer, feed, amp, tol):
    """The step block's weights' gradients (the attention score's, the
    two input projections', gru_unit's weight and bias) from one step on
    the card against the same step on CPUPlace() from identical state:
    each within ``tol`` of max|CPU| and not zero.  Their grad op replays
    the loop under autograd; the card's products there launch through
    ``Matmul`` (a raw launch would raise), and a product autograd could
    not see would leave its weight's gradient zero or short of the
    CPU's."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import matmul as kmatmul

    prog, _, cost, _, step_params = seq2seq_parts(trainer)
    state = {n: v.cpu() for n, v in trainer.parameters.scope.values.items()}
    fetch = [cost.name] + [n + "@GRAD" for n in step_params]
    runs = []
    for place in (pt.CUDAPlace(0), pt.CPUPlace()):
        scope = pt.Scope()
        scope.values.update({n: v.to(place.device())
                             for n, v in state.items()})
        before = kmatmul.launches + kmatmul.launches_bf16
        with pt.amp.amp_guard(amp):
            runs.append(pt.Executor(place).run(prog, feed=feed,
                                               fetch_list=fetch, scope=scope))
        if isinstance(place, pt.CUDAPlace):
            replayed = kmatmul.launches + kmatmul.launches_bf16 - before
        del scope
    want_launches = sum(seq2seq_matmul_shapes(
        steps=feed["trg_in"].shape[1], batch=feed["trg_in"].shape[0]).values())
    if replayed != want_launches:
        fail(f"seq2seq step block: {replayed} matmul launches on the card, "
             f"not {want_launches}")
    worst = []
    for name, g, w in zip(fetch[1:], runs[0][1:], runs[1][1:]):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        if not (scale > 0 and float(np.abs(g).max()) > 0):
            fail(f"seq2seq step block: {name} is zero on the card or the "
                 "CPU")
        if not err <= tol * scale:
            fail(f"seq2seq step block: {name} on the card differs from the "
                 f"CPU: max err {err:.3e} > {tol} x {scale:.3e}")
        worst.append((err / scale, name))
    log(f"seq2seq step block's weights ({'AMP' if amp else 'f32'}), card vs "
        f"CPU: {', '.join(f'{n} {e:.2e}' for e, n in sorted(worst)[::-1])} "
        f"(tolerance {tol} of max; {replayed} matmul launches, the replay's "
        "through Matmul)")


def phase_seq2seq_parity(dev, amp=False):
    """Phase 15e (f32) / 15g (AMP): the cell at full width, B
    S2S_PARITY_BATCH, S S2S_PARITY_SEQ, ragged lengths: its Trainer built
    on the card through parse_config; one step on the card against
    CPUPlace() from identical weights, end to end and op by op
    (seq_step_parity / amp_step_parity: the loss, every parameter's
    gradient, every parameter and Adam moment after the update), then
    the step block's weights explicitly (``_seq2seq_step_block_grads``)."""
    import torch

    t = seq2seq_trainer(batch=S2S_PARITY_BATCH)
    prog, startup, cost, params_grads, step_params = seq2seq_parts(t)
    feed = seq2seq_feed(S2S_PARITY_BATCH, S2S_PARITY_SEQ, seed=9,
                        ragged=True)
    what = (f"seq2seq step parity at full width, B {S2S_PARITY_BATCH} S "
            f"{S2S_PARITY_SEQ}, src lengths {feed['src@len'].tolist()}, "
            f"target lengths {feed['trg_in@len'].tolist()}")
    if amp:
        amp_step_parity(dev, prog, startup, cost, params_grads, feed, what)
    else:
        seq_step_parity(dev, prog, startup, cost, params_grads, feed, what)
    _seq2seq_step_block_grads(dev, t, feed, amp,
                              AMP_PARITY_TOL if amp else PARITY_TOL)
    del t
    torch.cuda.empty_cache()


def seq2seq_flops():
    """run.py:302-306's model FLOPs of one step (matmul terms, x3 for the
    forward and backward)."""
    s, emb, hid, vocab = S2S_SEQ, S2S_EMB, S2S_HID, S2S_VOCAB
    per_tok = (emb * 3 * hid + 3 * hid * hid + 2 * hid * hid + 2 * s * hid
               + (emb + hid) * 3 * hid + 3 * hid * hid + hid * vocab)
    return 3 * 2 * per_tok * S2S_BATCH * s


def phase_seq2seq_step(dev, smi, amp=False):
    """Phase 15f (f32) / 15h (AMP): the cell at run.py's size through its
    entry points: parse_config -> Trainer (CUDAPlace(0)) -> Executor.run
    of the topology's program under scope_guard(t.parameters.scope),
    the feeds staged on the card, run.py's BENCH_CHAIN=0 loop.  The
    counters zeroed just before the first step and read just after: the
    launches ``launches_implied`` gives (matmul 194, bf16 under AMP, 2 on
    a wgmma engine), nothing else; tokens/s and ms a step over
    S2S_TIMED steps after S2S_WARMUP warm-up steps (one sync after the
    timed steps, as run.py), model TFLOP/s, peak memory; the loss of the
    fixed batch falls over the timed steps."""
    import torch

    import paddle_tpu_torch as pt

    kind = "AMP bf16" if amp else "f32"
    mm = "matmul_bf16" if amp else "matmul"
    t = seq2seq_trainer()
    prog, _, cost, _, _ = seq2seq_parts(t)
    want = launches_implied(prog, amp, steps=S2S_SEQ)
    expect = dict.fromkeys(KERNELS, 0)
    expect[mm] = sum(seq2seq_matmul_shapes().values())
    if want != expect:
        fail(f"seq2seq {kind}: the program implies {want}, not {expect}")
    rule = kmatmul_rule(amp)
    want_wgmma = dict.fromkeys(wgmma_counters(), 0)
    want_wgmma[mm] = sum(c for (m, k, n), c in seq2seq_matmul_shapes().items()
                         if rule(m, k, n, 0, 0) == "wgmma")
    feed = seq2seq_feed(S2S_BATCH, S2S_SEQ, device=dev)
    exe = pt.Executor()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    with pt.scope_guard(t.parameters.scope), pt.amp.amp_guard(amp):
        zero_counters()
        t0 = time.perf_counter()
        (first,) = exe.run(prog, feed=feed, fetch_list=[cost.name])
        first_s = time.perf_counter() - t0
        launches, wgmma = counters(), wgmma_counters()
        log(f"seq2seq {kind} step at B {S2S_BATCH} S {S2S_SEQ}: first step "
            f"loss {float(first):.5f} in {first_s:.2f} s; launches "
            f"{ {k: v for k, v in launches.items() if v} }, on a wgmma "
            f"engine { {k: v for k, v in wgmma.items() if v} }")
        if launches != want:
            fail(f"seq2seq {kind}: launch counts {launches} != {want}")
        if wgmma != want_wgmma:
            fail(f"seq2seq {kind}: wgmma launch counts {wgmma} != "
                 f"{want_wgmma}")
        for _ in range(S2S_WARMUP - 1):
            exe.run(prog, feed=feed, fetch_list=[cost.name],
                    return_numpy=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(S2S_TIMED):
            (val,) = exe.run(prog, feed=feed, fetch_list=[cost.name],
                             return_numpy=False)
            losses.append(val)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / S2S_TIMED
    peak = torch.cuda.max_memory_allocated()
    losses = [float(first)] + [float(v) for v in losses]
    if not np.isfinite(losses).all() or not losses[-1] < losses[1]:
        fail(f"seq2seq {kind}: losses {losses} (non-finite, or the fixed "
             "batch's loss did not fall over the timed steps)")
    tokens = S2S_BATCH * S2S_SEQ
    tflops = seq2seq_flops() / dt / 1e12
    log(f"seq2seq train step at B {S2S_BATCH} S {S2S_SEQ} ({kind}): "
        f"{tokens / dt:.1f} tokens/s, {dt * 1e3:.3f} ms a step over "
        f"{S2S_TIMED} timed steps after {S2S_WARMUP} warm-up steps; model "
        f"{seq2seq_flops() / 1e9:.1f} GFLOP a step = {tflops:.2f} TFLOP/s "
        f"(peaks: f32 {PEAK_F32_FLOPS / 1e12:.0f}, TF32 "
        f"{PEAK_TF32_FLOPS / 1e12:.0f}, bf16 {PEAK_BF16_FLOPS / 1e12:.0f}); "
        f"losses {[round(x, 5) for x in losses]}; peak memory allocated "
        f"{peak / 2**30:.3f} GiB on {smi}")
    del exe, t
    torch.cuda.empty_cache()
    return dict(tokens_per_s=tokens / dt, ms_per_step=dt * 1e3,
                tflops=tflops, peak_bytes=peak, launches=launches,
                wgmma=wgmma)


def kmatmul_rule(bf16):
    from paddle_tpu_torch.kernels import matmul as kmatmul

    return kmatmul.bf16_engine if bf16 else kmatmul.f32_engine


def seq2seq_profile_paths(dev):
    """profile_paths' entries for the seq2seq step at run.py's size, f32
    and AMP, from phase 15f's feed: the matmul kernel (the two B x S-row
    projections on a wgmma engine, the step block's 192 products on the
    SIMT or mma.sync tile), the mul backward products and the host time inside the loop ops (``recurrent``, its grad op and
    the replay inside it, ``gru``, likewise) split out."""
    t = seq2seq_trainer()
    prog, startup, cost, _, _ = seq2seq_parts(t)
    feed = seq2seq_feed(S2S_BATCH, S2S_SEQ, device=dev)
    small = sum(c for (m, k, n), c in seq2seq_matmul_shapes().items()
                if kmatmul_rule(False)(m, k, n, 0, 0) != "wgmma")
    range_ops("recurrent", "recurrent_grad", "gru", "gru_grad")
    # the ranges range_ops opens: a grad op's replay of its forward is a
    # range of its own inside the grad op's
    loops = ("recurrent", "recurrent replayed", "recurrent_grad", "gru",
             "gru replayed", "gru_grad")

    def path(mm, kind):
        return (prog, startup, cost, feed,
                f"seq2seq step at B {S2S_BATCH} S {S2S_SEQ} ({kind})",
                {"matmul kernel": list(mm) + ["wgmma_tf32_split"],
                 "mul backward products": "matmul_backward"}, mm, loops)

    return {"seq2seq": (False, path({"wgmma_tf32_kernel": 2,
                                     "matmul_f32_kernel": small}, "f32")),
            "seq2seq_amp": (True, path({"wgmma_gemm_kernel": 2,
                                        "matmul_bf16_kernel": small},
                                       "AMP bf16"))}


def range_ops(*types):
    """Wrap every later run of the ops of ``types`` (a grad op's type
    too) in a torch.profiler record_function range named after the type
    (for the profiled split: the host time inside each); a grad op's
    replay of its forward, which runs with autograd on, in one named
    "<type> replayed", inside the grad op's range."""
    import torch

    from paddle_tpu_torch.registry import OpRegistry

    for t in types:
        info = OpRegistry.get(t)

        def lower(ctx, _fn=info.lower, _t=t):
            name = _t + " replayed" if torch.is_grad_enabled() else _t
            with torch.profiler.record_function(name):
                return _fn(ctx)

        info.lower = lower


def range_calls(mod, name):
    """Wrap every later call of ``mod.name`` in a torch.profiler
    record_function range of that name (for the profiled split)."""
    import torch

    fn = getattr(mod, name)

    def call(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)

    setattr(mod, name, call)


def profile_sequence_steps():
    """The body of ``chip_smoke.py --profile-sequence-steps``: one profiled
    step of each sequence path, from the same seeds as phases 12 and 15,
    and of the wide_deep and seq2seq steps in f32 and under AMP (phases
    15b, 15d, 15f and 15h), after 2 warm-up steps, split into the port's
    kernels (the LSTM forward and backward kernels apart) and the mul
    backward products.  Prints the idle shares as the last line, a JSON
    object."""
    import torch

    from paddle_tpu_torch.kernels import matmul as kmatmul

    dev = torch.device("cuda", 0)
    range_calls(kmatmul, "matmul_backward")
    lstm_prog, lstm_startup, _, lstm_loss, _ = build_lstm_program()
    lod_prog, lod_startup, lod_loss, _ = build_lod_program()

    def lstm_path(mm, kind):
        return (lstm_prog, lstm_startup, lstm_loss, lstm_step_feed(dev),
                f"LSTM classifier step at B {LSTM_BATCH} T {LSTM_SEQ} "
                f"({kind})",
                {"LSTM kernel": ["lstm_fwd_kernel"],
                 "LSTM backward kernel": ["lstm_bwd_kernel"],
                 # with the split passes of the f32 wgmma engine
                 "matmul kernel": list(mm) + ["wgmma_tf32_split"],
                 "mul backward products": "matmul_backward"},
                {"lstm_fwd_kernel": 2, "lstm_bwd_kernel": 2, **mm,
                 "softmax_warp_kernel": 1})

    paths = {
        # the two 6400-row projections on the split-TF32 wgmma engine, the
        # 64-row head (N 2) on the SIMT tile
        "lstm": (False, lstm_path({"wgmma_tf32_kernel": 2,
                                   "matmul_f32_kernel": 1}, "f32")),
        # the two 6400-row projections on the wgmma engine, the 64-row
        # head on the mma.sync tile
        "lstm_amp": (True, lstm_path({"wgmma_gemm_kernel": 2,
                                      "matmul_bf16_kernel": 1},
                                     "AMP bf16")),
        "lod": (False, (lod_prog, lod_startup, lod_loss,
                        lod_feed(np.random.RandomState(8), dev),
                        f"LoD classifier step, {LOD_SEQS} sequences",
                        {"gather kernel": ["gather_rows_kernel"],
                         "matmul kernel": ["wgmma_tf32", "matmul_f32_kernel"],
                         "mul backward products": "matmul_backward"},
                        {"gather_rows_kernel": 1, "wgmma_tf32_kernel": 1,
                         "matmul_f32_kernel": 1, "softmax_warp_kernel": 1})),
        **wide_deep_profile_paths(dev),
        **seq2seq_profile_paths(dev),
    }
    profile_paths(paths)


def profile_tail_steps():
    """The body of ``chip_smoke.py --profile-tail-steps``: one profiled
    step of the semantic-role tagger and of the text conv net (phases 15o
    and 15p) after 2 warm-up steps, in a process of their own: at the
    end of the sequence steps' child the profiler dropped the text conv
    step's gather launch from every window.  Prints the idle shares as
    the last line, a JSON object."""
    import torch

    from paddle_tpu_torch.kernels import matmul as kmatmul

    range_calls(kmatmul, "matmul_backward")
    profile_paths(tail_profile_paths(torch.device("cuda", 0)))


def tail_profile_paths(dev):
    """profile_paths' entries for the semantic-role tagger's step (phase
    15o, B SRL_BATCH) and the text conv net's (15p, LOD_SEQS sequences):
    the LSTM kernels 8 + 8, the gather 1, the matmul kernel (the split
    passes of the f32 wgmma engine with it) and the mul backward
    products."""
    import paddle_tpu_torch as pt

    mm = ["wgmma_tf32", "matmul_f32_kernel"]
    srl_prog, srl_startup, srl_cost, _ = build_srl(pt, **SRL_CONFIG)
    srl_feed_ = _card_feed(srl_feed(np.random.RandomState(37), SRL_BATCH),
                           dev)
    text_prog, text_startup, text_loss = build_text_conv(pt)
    text_feed = _card_feed(text_conv_feed(np.random.RandomState(38)), dev)
    return {
        "srl": (False, (srl_prog, srl_startup, srl_cost, srl_feed_,
                        f"SRL tagger step at B {SRL_BATCH}",
                        {"LSTM kernel": ["lstm_fwd_kernel"],
                         "LSTM backward kernel": ["lstm_bwd_kernel"],
                         "matmul kernel": mm,
                         "mul backward products": "matmul_backward"},
                        {"lstm_fwd_kernel": 8, "lstm_bwd_kernel": 8})),
        "text_conv": (False, (text_prog, text_startup, text_loss, text_feed,
                              f"text conv step, {LOD_SEQS} sequences",
                              {"gather kernel": ["gather_rows_kernel"],
                               "matmul kernel": mm,
                               "mul backward products": "matmul_backward"},
                              {"gather_rows_kernel": 1})),
    }


def wide_deep_profile_paths(dev):
    """profile_paths' entries for the wide_deep step, f32 and AMP, from
    phase 15b's feed: the matmul kernel (the 416 x 256 and 256 x 128
    layers on a wgmma engine, the N 1 head on the SIMT or mma.sync tile)
    and the mul backward products split out."""
    prog, startup, loss, _ = build_wide_deep_program()

    def path(mm, kind):
        return (prog, startup, loss, wide_deep_feed(WD_BATCH, device=dev),
                f"wide_deep step at B {WD_BATCH} ({kind})",
                {"matmul kernel": list(mm) + ["wgmma_tf32_split"],
                 "mul backward products": "matmul_backward"}, mm)

    return {"wide_deep": (False, path({"wgmma_tf32_kernel": 2,
                                       "matmul_f32_kernel": 1}, "f32")),
            "wide_deep_amp": (True, path({"wgmma_gemm_kernel": 2,
                                          "matmul_bf16_kernel": 1},
                                         "AMP bf16"))}


def profile_paths(paths):
    """{key: (amp, (program, startup, loss, feed, what, split, want[,
    host_ranges]))}: one profiled step of each after 2 warm-up steps
    (profile_step); prints {key: idle share} as the last line, a JSON
    object."""
    import paddle_tpu_torch as pt

    idle = {}
    for key, (amp, (prog, startup, loss, feed, what, split, want,
                    *host)) in paths.items():
        with pt.amp.amp_guard(amp):
            exe = pt.Executor()
            scope = pt.Scope()
            exe.run(startup, scope=scope)
            for _ in range(2):
                exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
            idle[key] = profile_step(
                lambda: exe.run(prog, feed=feed, fetch_list=[loss],
                                scope=scope), what, split, want, *host)
        del exe, scope
    print(json.dumps(idle), flush=True)


def profile_transformer_steps():
    """The body of ``chip_smoke.py --profile-transformer-steps``: one
    profiled transformer step at B 8, S 1024 in f32 and under AMP, from
    the seeds of phases 9 and 10b, split into the flash kernels, the
    matmul kernel and the mul backward products (cuBLAS).  Prints the
    idle shares as the last line, a JSON object."""
    import torch

    from paddle_tpu_torch.kernels import matmul as kmatmul

    dev = torch.device("cuda", 0)
    range_calls(kmatmul, "matmul_backward")
    prog, startup, loss, _ = build_transformer_program(TF_SEQ)
    feed = transformer_step_feed(dev)
    layers = TF_CONFIG["num_layers"]

    def path(amp):
        kind = "AMP bf16" if amp else "f32"
        # the f32 forward and backward run the split-TF32 kernels
        sfx = "_bf16" if amp else "_tf32"
        # every product of the step (8192 rows) on a wgmma engine, in f32
        # the split-TF32 one (its split passes beside it)
        mm = "wgmma_gemm_kernel" if amp else "wgmma_tf32_kernel"
        return amp, (prog, startup, loss, feed,
                     f"transformer step at B {TF_BATCH} S {TF_SEQ} ({kind})",
                     {"flash kernels": ["flash_"],
                      "matmul kernel": [mm, "wgmma_tf32_split"],
                      "mul backward products": "matmul_backward"},
                     {f"flash_fwd{sfx}_kernel": layers,
                      f"flash_dq{sfx}_kernel": layers,
                      f"flash_dkv{sfx}_kernel": layers, mm: 4 * layers + 1})

    profile_paths({"tf": path(False), "tf_amp": path(True)})


def profile_in_child(flag, what):
    """Run this script with ``flag`` in a fresh process and log its
    output: late in a long process, torch.profiler leaves out ctypes
    launches that start soon after they are queued, and a fresh process
    records them all (each profile fails if it sees fewer launches than
    its step makes).  Returns the JSON object of the child's last line."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), flag],
                          capture_output=True, text=True, timeout=600,
                          cwd=HERE)
    for line in proc.stdout.splitlines()[:-1]:
        log(line)
    if proc.returncode != 0:
        fail(f"the profiled {what} failed (exit {proc.returncode}):"
             f"\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.splitlines()[-1])


def phase_seq_profile():
    """One profiled step of each sequence path, in a fresh process (this
    script with PROFILE_SEQ).  Returns {path: idle share}."""
    return profile_in_child(PROFILE_SEQ, "sequence steps")


def phase_tail_profile():
    """One profiled step of the tagger and of the text conv net, in a
    fresh process (this script with PROFILE_TAIL).  Returns {path: idle
    share}."""
    return profile_in_child(PROFILE_TAIL, "fluid tail steps")


# ---------------------------------------------------------------------------
# generation serving: the paged kernels, the decoder LM, /generate
# ---------------------------------------------------------------------------


def paged_case(randn, rng, s, h, d, page, p, n, lens, t=None):
    """Seeded q and pools on the card; a table of distinct random pages
    for each slot, null page 0 as the padding past the pages its rows
    reach; int32 lens."""
    import torch

    dev = randn(1).device
    q = randn(s, h, d) if t is None else randn(s, t, h, d)
    kp, vp = randn(n, page, h, d), randn(n, page, h, d)
    tables = (rng.permutation(n - 1)[:s * p].reshape(s, p) + 1).astype(
        np.int32)
    for i, ln in enumerate(lens):
        tables[i, min(p, -(-(ln + (t or 0)) // page)):] = 0
    return (q, kp, vp, torch.as_tensor(tables, device=dev),
            torch.as_tensor(np.asarray(lens, np.int32), device=dev))


def paged_work(lens, t, h, d, page, p, chunk):
    """(FLOPs, bytes) of one launch: the K and V rows up to each slot's
    longest row limit read once, q read and out written once, the tables
    and lens read; 4 FLOPs per (query row, position, head, d)."""
    cap, rows, pairs = p * page, 0, 0
    for ln in lens:
        lims = [min(max(ln + j + int(chunk), 0), cap) for j in range(t)]
        rows += max(lims)
        pairs += sum(lims)
    s = len(lens)
    return (4.0 * pairs * h * d,
            4.0 * (2 * rows * h * d + 2 * s * t * h * d + s * p + s))


def gather_sdpa(q4, kp, vp, tables, lens, row_offset):
    """The comparison: gather every page of the table (``k_pages[tables]``)
    and F.scaled_dot_product_attention with the length mask: two calls."""
    import torch
    import torch.nn.functional as F

    s, t, h, d = q4.shape
    page, p = kp.shape[1], tables.shape[1]
    k = kp[tables.long()].reshape(s, p * page, h, d).transpose(1, 2)
    v = vp[tables.long()].reshape(s, p * page, h, d).transpose(1, 2)
    limit = (lens.long()[:, None] + row_offset
             + torch.arange(t, device=q4.device)[None, :])
    mask = torch.arange(p * page, device=q4.device)[None, None] < limit[
        ..., None]
    return F.scaled_dot_product_attention(q4.transpose(1, 2), k, v,
                                          attn_mask=mask[:, None]
                                          ).transpose(1, 2)


def phase_paged_kernels(dev, randn):
    """A. The paged kernels against their plain versions (PAGED_ATOL): the
    decode kernel at the slice's shape (S 16, H 16, D 128, page 16, P 128)
    with seeded ragged lens in 1-2048 (1, 16, 17 and 2048 among them) and
    at a small ragged shape (S 5, H 2, D 16, page 8); the chunk kernel at
    S 16, T 4 (the speculative verify) and at S 1, T 88 over 512 cached
    rows (a prefix-hit suffix), each beside the chunk's first design
    (``kpa._launch(..., chunk=True)``, uncounted) and bit for bit across
    two calls; the chunk kernel also at T 1 on the decode lens (lens - 1),
    which no path routes there.  CUDA-event medians of each kernel, its
    plain version and the gather + SDPA comparison, beside the bound, and
    each kernel's device time and its wrapper's host us a call; the
    kernels line carries them per decode (verify) step, 4 launches."""
    import torch

    from paddle_tpu_torch.kernels import paged_attention as kpa

    rng = np.random.RandomState(51)
    cfg = DEC_CONFIG
    h, page, p = cfg["num_heads"], cfg["page_size"], cfg["pages_per_seq"]
    d = cfg["d_model"] // h
    n, count = cfg["num_pages"], cfg["num_layers"]
    results = {}

    def run(name, tag, s, hh, dd, pg, pp, nn, lens, t=None, time_it=False):
        chunk = t is not None
        q, kp, vp, tables, lens_t = paged_case(randn, rng, s, hh, dd, pg, pp,
                                               nn, lens, t)
        kernel = kpa.paged_attention_chunk if chunk else kpa.paged_attention
        plain = (kpa.paged_attention_chunk_plain if chunk
                 else kpa.paged_attention_plain)
        q4 = q if chunk else q[:, None]
        got = kernel(q, kp, vp, tables, lens_t)
        want = plain(q, kp, vp, tables, lens_t)
        err = check_close(f"{name} {tag}", got, want, rtol=0, atol=PAGED_ATOL)
        cmp_out = gather_sdpa(q4, kp, vp, tables, lens_t, int(chunk))
        cmp_err = check_close(f"gather + SDPA {tag}",
                              cmp_out if chunk else cmp_out[:, 0], want,
                              rtol=0, atol=PAGED_ATOL)
        if not time_it:
            log(f"  {name} {tag}: max err {err:.2e} (atol {PAGED_ATOL}); "
                f"gather + SDPA {cmp_err:.2e}")
            return None
        ms = time_ms(lambda: kernel(q, kp, vp, tables, lens_t))
        plain_ms = time_ms(lambda: plain(q, kp, vp, tables, lens_t), reps=5)
        cmp_ms = time_ms(lambda: gather_sdpa(q4, kp, vp, tables, lens_t,
                                             int(chunk)), reps=5)
        flops, nbytes = paged_work(lens, t or 1, hh, dd, pg, pp, chunk)
        b_ms, b_by = bound(flops, nbytes)
        log(f"  {name} {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"gather + SDPA (two calls) {cmp_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}, {nbytes / 1e6:.1f} MB), {nbytes / ms / 1e6:.1f} GB/s, "
            f"max err {err:.2e}, gather + SDPA err {cmp_err:.2e}")
        host = host_us(lambda: kernel(q, kp, vp, tables, lens_t))
        dev = sum(device_ms(lambda: kernel(q, kp, vp, tables,
                                           lens_t)).values()) or None
        log(f"  {name} {tag}: device time {dev} ms; the wrapper's host work "
            f"{host:.1f} us a call")
        r = dict(ms=ms, plain_ms=plain_ms, gather_sdpa_ms=cmp_ms,
                 bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                 flops=flops, nbytes=nbytes, device_ms=dev, host_us=host)
        if chunk:
            if not torch.equal(got, kernel(q, kp, vp, tables, lens_t)):
                fail(f"{name} {tag}: two calls differ")

            def first():
                return kpa._launch(q, kp, vp, tables, lens_t, None,
                                   chunk=True)

            old_err = check_close(f"{name} {tag} (first design)", first(),
                                  want, rtol=0, atol=PAGED_ATOL)
            r["old_ms"] = time_ms(first)
            r["old_device_ms"] = sum(device_ms(first).values()) or None
            log(f"  {name} {tag}: the first design {r['old_ms']:.4f} ms, "
                f"device {r['old_device_ms']} ms (max err {old_err:.2e}); "
                f"the redesign's device time "
                + (f"{r['old_device_ms'] / dev:.2f}x faster"
                   if dev and r["old_device_ms"] else "not measured"))
        return r

    lens = rng.randint(1, p * page + 1, DEC_SLOTS)
    lens[:4] = (1, 16, 17, p * page)
    lens = [int(x) for x in lens]
    log(f"paged kernels, pool {n} pages of {page} x {h} x {d}, tables of "
        f"{p} pages; decode lens {lens}")
    dec = run("paged_attention", f"S{DEC_SLOTS} H{h} D{d} ragged",
              DEC_SLOTS, h, d, page, p, n, lens, time_it=True)
    full = run("paged_attention", f"S{DEC_SLOTS} every lens {p * page}",
               DEC_SLOTS, h, d, page, p, n, [p * page] * DEC_SLOTS,
               time_it=True)
    run("paged_attention", "S5 H2 D16 page 8 ragged", 5, 2, 16, 8, 3, 16,
        [3, 8, 17, 1, 24])
    vlens = [int(x) for x in rng.randint(1, p * page - 4, DEC_SLOTS)]
    ver = run("paged_attention_chunk", f"S{DEC_SLOTS} T4 ragged", DEC_SLOTS,
              h, d, page, p, n, vlens, t=4, time_it=True)
    suffix = run("paged_attention_chunk", "S1 T88 over 512 cached rows", 1,
                 h, d, page, p, n, [GEN_SHARED_PREFIX], t=88, time_it=True)
    single = run("paged_attention_chunk",
                 f"S{DEC_SLOTS} T1 on the decode lens (not routed)",
                 DEC_SLOTS, h, d, page, p, n, [ln - 1 for ln in lens], t=1,
                 time_it=True)
    log(f"  the bound at every lens {p * page} is {full['bound_ms']:.4f} ms "
        f"({full['nbytes'] / 1e6:.0f} MB at {PEAK_BYTES / 1e12} TB/s); the "
        f"kernel takes {full['ms'] / full['bound_ms']:.2f}x it there, "
        f"{dec['ms'] / dec['bound_ms']:.2f}x at the ragged lens; the chunk "
        f"kernel {ver['ms'] / ver['bound_ms']:.2f}x at S16 T4, "
        f"{suffix['ms'] / suffix['bound_ms']:.2f}x at S1 T88; at T1 on the "
        f"decode lens its device time {single['device_ms']} ms against the "
        f"decode kernel's {dec['device_ms']} ms")
    for name, r in (("paged_attention", dec), ("paged_attention_chunk", ver)):
        b_ms, b_by = bound(count * r["flops"], count * r["nbytes"])
        results[name] = dict(
            ms=count * r["ms"], plain_ms=count * r["plain_ms"],
            library_ms=None, gather_sdpa_ms=count * r["gather_sdpa_ms"],
            bound_ms=b_ms, bound_by=b_by, max_abs_err=r["max_abs_err"],
            device_ms=r["device_ms"] and count * r["device_ms"],
            host_us=r["host_us"])
    chunk = results["paged_attention_chunk"]
    chunk.update(
        old_ms=count * ver["old_ms"],
        old_device_ms=ver["old_device_ms"] and count * ver["old_device_ms"],
        suffix_ms=suffix["ms"], suffix_device_ms=suffix["device_ms"],
        suffix_old_device_ms=suffix["old_device_ms"],
        suffix_bound_ms=suffix["bound_ms"],
        t1_device_ms=single["device_ms"])
    return results


def _scaled_check(what, got, want):
    """max|got - want| <= DEC_PARITY_TOL * max|want|; returns the ratio."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        fail(f"{what}: shape {got.shape} vs {want.shape}, or non-finite")
    ratio = float(np.abs(got - want).max() / np.abs(want).max())
    if ratio > DEC_PARITY_TOL:
        fail(f"{what}: max abs err {ratio:.2e} x max|reference| > "
             f"{DEC_PARITY_TOL}")
    return ratio


def _near_tie(row, tol):
    top2 = np.partition(np.asarray(row, np.float64), -2)[-2:]
    return top2[1] - top2[0] < tol * np.abs(row).max()


def _same_ids(what, got, want):
    """Rows' argmax equal, except where the reference's top-2 gap is a
    near-tie.  Returns the number of near-tie flips."""
    got = np.asarray(got).reshape(-1, np.asarray(got).shape[-1])
    want = np.asarray(want).reshape(got.shape)
    flips = 0
    for g, w in zip(got, want):
        if int(np.argmax(g)) != int(np.argmax(w)):
            if not _near_tie(w, DEC_PARITY_TOL):
                fail(f"{what}: argmax {int(np.argmax(g))} vs "
                     f"{int(np.argmax(w))} without a near-tie")
            flips += 1
    return flips


def decode_model(place=None, params=None, **overrides):
    from paddle_tpu_torch.decode.model import TinyDecoderLM

    return TinyDecoderLM(**dict(DEC_CONFIG, **overrides), seed=DEC_SEED,
                         place=place, params=params)


def phase_decode_parity(dev):
    """B and E. The full-width decoder LM on the card against the port's
    CPU path from the same weights: a cold prefill of 4 ragged prompts,
    DEC_PARITY_STEPS decode steps teacher-forced with the CPU's tokens,
    one verify step of 4 tokens a slot and one prefix-hit prefill (512
    cached rows); logits within DEC_PARITY_TOL of max|CPU| at every step,
    ids equal up to near-ties.  The launch counters, zeroed around each
    card call, must read: cold prefill flash forward 4; decode step paged
    4; verify step chunk 4; prefix-hit prefill chunk 4; nothing else.
    Returns the card model and {call: launches}."""
    import torch

    import paddle_tpu_torch as pt

    t0 = time.perf_counter()
    card = decode_model()
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(x.shape)) for x in (
        [card.params["emb"], card.params["pos"], card.params["ln_f"]]
        + [t for lp in card.params["layers"] for t in lp.values()]))
    cpu = decode_model(pt.CPUPlace(), card.to_numpy(), num_pages=256)
    log(f"decoder LM: {n_params / 1e6:.1f} M parameters "
        f"({4 * n_params / 2**30:.2f} GiB f32), K/V pools "
        f"{2 * card.k_pool.numel() * 4 / 2**30:.2f} GiB on {card.place!r}; "
        f"a CPU copy from the same weights ({time.perf_counter() - t0:.1f} s)")
    rng = np.random.RandomState(61)
    v = DEC_CONFIG["vocab"]
    prompts = [[int(x) for x in rng.randint(2, v, n)]
               for n in DEC_PARITY_PROMPTS]
    counts, ratios, flips = {}, [], 0

    def both(call, what, want_launches):
        zero_counters()
        got = call(card)
        torch.cuda.synchronize()
        launches = counters()
        expect = dict.fromkeys(KERNELS, 0)
        expect.update(want_launches)
        if launches != expect:
            fail(f"{what}: launches {launches}, want {want_launches}")
        counts[what] = launches
        return got, call(cpu)

    pages, first = [], []
    for prompt in prompts:
        need = card.context_pages(prompt, DEC_PARITY_STEPS + 4)
        pg = card.allocator.alloc(need)
        if cpu.allocator.alloc(need) != pg:
            fail("the two allocators handed out different pages")
        pages.append(pg)
        (_, _, got), (_, _, want) = both(
            lambda m: m.prefill(prompt, pg), "cold_prefill",
            dict(flash_attention_fwd=DEC_CONFIG["num_layers"]))
        ratios.append(_scaled_check(f"cold prefill of {len(prompt)} tokens",
                                    got, want))
        flips += _same_ids("cold prefill", got[None], want[None])
        first.append(int(np.argmax(want)))
    tables = np.stack([card.pool_table(pg) for pg in pages])
    lens = np.array([len(x) for x in prompts], np.int64)
    toks = np.array(first, np.int64)[:, None]
    for step in range(DEC_PARITY_STEPS):
        (got, _), (want, _) = both(
            lambda m: m.decode(toks, [], tables, lens), "decode_step",
            dict(paged_attention=DEC_CONFIG["num_layers"]))
        ratios.append(_scaled_check(f"decode step {step}", got, want))
        flips += _same_ids(f"decode step {step}", got, want)
        toks = np.argmax(want, axis=-1)[:, None]      # teacher-forced
        lens = lens + 1
    chunk = np.concatenate([toks, rng.randint(2, v, (len(prompts), 3))], 1)
    (got, _), (want, _) = both(
        lambda m: m.verify_chunk(chunk, [], tables, lens), "verify_step",
        dict(paged_attention_chunk=DEC_CONFIG["num_layers"]))
    ratios.append(_scaled_check("verify step", got, want))
    flips += _same_ids("verify step", got, want)
    ps = DEC_CONFIG["page_size"]
    hit = prompts[2][:GEN_SHARED_PREFIX] + [int(x) for x in
                                            rng.randint(2, v, 40)]
    hit_pages = []
    for m in (card, cpu):
        hp = m.allocator.fork(pages[2][:GEN_SHARED_PREFIX // ps])
        hit_pages.append(hp + m.allocator.alloc(
            m.context_pages(hit, 0) - len(hp)))
    if hit_pages[0] != hit_pages[1]:
        fail("the two allocators handed out different pages")
    (_, _, got), (_, _, want) = both(
        lambda m: m.prefill(hit, hit_pages[0],
                            cached_len=GEN_SHARED_PREFIX),
        "prefix_prefill",
        dict(paged_attention_chunk=DEC_CONFIG["num_layers"]))
    ratios.append(_scaled_check("prefix-hit prefill", got, want))
    flips += _same_ids("prefix-hit prefill", got[None], want[None])
    for m in (card, cpu):   # both allocators hold the same page lists
        for pg in pages + hit_pages[:1]:
            m.allocator.free(pg)
    if card.allocator.pages_in_use:
        fail(f"{card.allocator.pages_in_use} pages leaked")
    log(f"decoder LM card vs CPU: prompts {list(DEC_PARITY_PROMPTS)}, "
        f"{DEC_PARITY_STEPS} teacher-forced decode steps, a verify step, a "
        f"prefix-hit prefill ({GEN_SHARED_PREFIX} cached rows + 40): "
        f"logits max abs err {max(ratios):.2e} x max|CPU| (tolerance "
        f"{DEC_PARITY_TOL}), {flips} near-tie argmax flips; launches per "
        "call " + "; ".join(
            f"{k}: " + ", ".join(f"{n} {c}" for n, c in v.items() if c)
            for k, v in counts.items()))
    del cpu
    return card, counts


def gen_call(addr, payload, timeout=600):
    """POST /generate: (status, body, seconds to the first streamed line
    or None, seconds to the end).  A streamed 200 body is its list of
    ndjson lines."""
    import http.client

    host, port = addr.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    t0 = time.perf_counter()
    try:
        conn.request("POST", "/generate", body=json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        ttft = None
        if resp.status == 200 and payload.get("stream", True) and (
                "beam" not in payload):
            body = []
            while True:
                line = resp.readline()
                if not line:
                    break
                if ttft is None:
                    ttft = time.perf_counter() - t0
                if line.strip():
                    body.append(json.loads(line))
        else:
            body = json.loads(resp.read() or b"null")
        return resp.status, body, ttft, time.perf_counter() - t0
    finally:
        conn.close()


def solo_greedy(model, prompt, n):
    """The request decoded alone (one slot, no prefix cache): (ids, the
    top-2 logit gap at each step, max|logits|)."""
    pages = model.allocator.alloc(model.context_pages(prompt, n))
    try:
        _, _, logits = model.prefill(prompt, pages)
        table = model.pool_table(pages)[None]
        ids, gaps, scale, length = [], [], 0.0, len(prompt)
        while True:
            top2 = np.partition(np.asarray(logits, np.float64), -2)[-2:]
            gaps.append(top2[1] - top2[0])
            scale = max(scale, float(np.abs(logits).max()))
            ids.append(int(np.argmax(logits)))
            if ids[-1] == model.eos_id or len(ids) == n:
                return ids, gaps, scale
            logits = model.decode(np.array([[ids[-1]]]), [], table,
                                  np.array([length]))[0][0]
            length += 1
    finally:
        model.allocator.free(pages)


def agrees(got, ref):
    """Greedy ids equal to the solo reference, or equal up to a first
    divergence at a near-tie of the reference (later ids then follow
    another context).  Returns None, or the divergence index."""
    ids, gaps, scale = ref
    for i, (a, b) in enumerate(zip(got, ids)):
        if a != b:
            if gaps[i] < DEC_PARITY_TOL * scale:
                return i
            fail(f"generated ids diverge at {i} ({a} vs {b}) without a "
                 f"near-tie (gap {gaps[i]:.3e}, tolerance "
                 f"{DEC_PARITY_TOL * scale:.3e})")
    if len(got) != len(ids):
        fail(f"{len(got)} generated ids, the solo reference has {len(ids)}")
    return None


def gen_requests():
    """GEN_REQUESTS seeded requests: prompts of 16-1024 tokens, the first
    8 sharing a GEN_SHARED_PREFIX-token prefix; every other one streamed;
    request 5 a beam of 2, request 6 sampled with a seed."""
    rng = np.random.RandomState(71)
    v = DEC_CONFIG["vocab"]
    shared = [int(x) for x in rng.randint(2, v, GEN_SHARED_PREFIX)]
    out = []
    for i in range(GEN_REQUESTS):
        if i < 8:
            prompt = shared + [int(x) for x in rng.randint(
                2, v, rng.randint(16, 1024 - GEN_SHARED_PREFIX))]
        else:
            prompt = [int(x) for x in rng.randint(2, v, rng.randint(16,
                                                                    1025))]
        payload = {"src": prompt, "max_new_tokens": GEN_NEW_TOKENS,
                   "stream": i % 2 == 0}
        if i == 5:
            payload["beam"] = 2
            del payload["stream"]
        if i == 6:
            payload.update(temperature=0.8, top_k=50, seed=7)
        out.append(payload)
    return out


def stepper_time():
    """{"steps": (count, seconds), "prefills": (count, seconds)}: the
    session's own histograms of its model.decode / verify_chunk calls and
    of its prefills."""
    from paddle_tpu_torch.observability import metrics

    snap = metrics.snapshot()
    out = {}
    for key, name in (("steps", "decode_step_seconds"),
                      ("prefills", "decode_prefill_seconds")):
        vals = snap.get(name, {"values": []})["values"]
        out[key] = (vals[0]["count"], vals[0]["sum"]) if vals else (0, 0.0)
    return out


def stepper_split(before, secs):
    """The wall time of a burst split into the session's model calls, its
    prefills and the rest (host bookkeeping, HTTP, waiting)."""
    after = stepper_time()
    (ns, ts), (np_, tp) = ((after[k][0] - before[k][0],
                            after[k][1] - before[k][1])
                           for k in ("steps", "prefills"))
    return (f"{ns} steps {1e3 * ts:.1f} ms ({1e3 * ts / max(ns, 1):.2f} ms "
            f"each), {np_} prefills {1e3 * tp:.1f} ms "
            f"({1e3 * tp / max(np_, 1):.2f} ms each), the rest "
            f"{1e3 * (secs - ts - tp):.1f} ms of {1e3 * secs:.1f}")


def step_ms(model, lens, reps=20):
    """Median host ms of model.decode at len(lens) active slots (the
    logits come back to the host: a device sync)."""
    pages = [model.allocator.alloc(model.context_pages([0] * n, 1))
             for n in lens]
    try:
        tables = np.stack([model.pool_table(pg) for pg in pages])
        toks = np.full((len(lens), 1), 5, np.int64)
        lens = np.asarray(lens, np.int64)
        times = []
        for i in range(reps + 3):
            t0 = time.perf_counter()
            model.decode(toks, [], tables, lens)
            if i >= 3:
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    finally:
        for pg in pages:
            model.allocator.free(pg)


def phase_generate(dev, model, smi):
    """C. /generate over HTTP at full width: InferenceServer(None,
    generator=GenerationEngine(model, max_slots=16, max_new_tokens=64,
    prefix_cache=True, beam_max=2)) on CUDAPlace(0), GEN_REQUESTS
    concurrent requests (gen_requests).  Each streamed reply's tokens
    equal its final ids; greedy ids equal the same request decoded alone
    (solo_greedy) up to near-ties; the beam is best-first; no page leaks
    (pages_in_use == the cache's cached_pages); a too-long prompt is a
    503 too_long and an expired deadline a 504.  The counters, zeroed
    just before the burst, show every kernel of the path launched.
    Logs tokens/s, time to first token and latency (p50/p99), the median
    decode-step ms at 16 slots, prefix-cache hits and peak memory.
    Returns the numbers, the launches and the solo references."""
    import torch

    from paddle_tpu_torch.decode import GenerationEngine
    from paddle_tpu_torch.serving import InferenceServer

    engine = GenerationEngine(model, max_slots=DEC_SLOTS,
                              max_new_tokens=GEN_NEW_TOKENS,
                              prefix_cache=True, beam_max=2)
    srv = InferenceServer(None, generator=engine)
    cache = engine.session.prefix_cache
    reqs = gen_requests()
    results = [None] * len(reqs)

    def one(i):
        results[i] = gen_call(srv.address, reqs[i])

    warm = gen_call(srv.address, {"src": [3, 4, 5], "max_new_tokens": 2,
                                  "stream": False})
    if warm[0] != 200:
        fail(f"/generate warm-up: {warm[0]} {warm[1]}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = stepper_time()
    zero_counters()
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(reqs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    burst_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = counters()
    peak = torch.cuda.max_memory_allocated()
    split = stepper_split(before, burst_s)
    for name in ("paged_attention", "paged_attention_chunk",
                 "flash_attention_fwd"):
        if not launches[name]:
            fail(f"the /generate burst launched no {name}: {launches}")
    if any(c for n, c in launches.items() if n not in (
            "paged_attention", "paged_attention_chunk",
            "flash_attention_fwd")):
        fail(f"the /generate burst launched other kernels: {launches}")
    tokens, ttfts, latencies, greedy = 0, [], [], {}
    for i, (payload, res) in enumerate(zip(reqs, results)):
        if res is None or res[0] != 200:
            fail(f"/generate request {i}: {res and res[:2]}")
        status, body, ttft, latency = res
        latencies.append(latency)
        if payload.get("stream", True) and "beam" not in payload:
            final = body[-1]
            streamed = [x["token"] for x in body[:-1]]
            if not final.get("done") or streamed != final["ids"]:
                fail(f"request {i}: streamed tokens {streamed[:8]}... != "
                     f"final ids {final.get('ids', [])[:8]}...")
            ids = final["ids"]
            ttfts.append(ttft)
        else:
            ids = body["ids"]
        if "beam" in payload:
            scores = [b["score"] for b in body["beams"]]
            if (scores != sorted(scores, reverse=True)
                    or body["beams"][0]["ids"] != ids):
                fail(f"beam reply not best-first: {body}")
        tokens += len(ids)
        if not (0 < len(ids) <= GEN_NEW_TOKENS) or not all(
                0 <= x < DEC_CONFIG["vocab"] for x in ids):
            fail(f"request {i}: {len(ids)} ids out of range")
        if "beam" not in payload and "temperature" not in payload:
            greedy[i] = ids
    stats = cache.stats()
    if stats["hits"] < 7:
        fail(f"the 8 requests sharing a {GEN_SHARED_PREFIX}-token prefix "
             f"hit the prefix cache {stats['hits']} times")
    refs, diverged = {}, 0
    for i, ids in greedy.items():
        refs[i] = solo_greedy(model, reqs[i]["src"], GEN_NEW_TOKENS)
        diverged += agrees(ids, refs[i]) is not None
    code, body, _, _ = gen_call(srv.address, {"src": [5] * 2000,
                                              "stream": False})
    if code != 503 or body.get("reason") != "too_long":
        fail(f"a 2000-token prompt: {code} {body}, want 503 too_long")
    late = InferenceServer(None, generator=engine, request_timeout=1e-6)
    try:
        code, body, _, _ = gen_call(late.address, {"src": [5, 6],
                                                   "stream": False})
    finally:
        late._httpd.shutdown()
        late._httpd.server_close()
    if code != 504:
        fail(f"an expired deadline: {code} {body}, want 504")
    ms16 = step_ms(model, [len(r["src"]) + GEN_NEW_TOKENS // 2
                           for r in reqs[:DEC_SLOTS]])
    if model.allocator.pages_in_use != cache.cached_pages:
        fail(f"pages leaked: {model.allocator.pages_in_use} in use, the "
             f"prefix cache holds {cache.cached_pages}")
    srv.stop()
    cache.clear()
    if model.allocator.pages_in_use:
        fail(f"{model.allocator.pages_in_use} pages in use after the cache "
             "was cleared")
    pct = lambda xs, q: float(np.percentile(xs, q))   # noqa: E731
    out = dict(tokens_per_s=tokens / burst_s, tokens=tokens, burst_s=burst_s,
               ttft_p50_ms=1e3 * pct(ttfts, 50),
               ttft_p99_ms=1e3 * pct(ttfts, 99),
               latency_p50_ms=1e3 * pct(latencies, 50),
               latency_p99_ms=1e3 * pct(latencies, 99), step_ms_16=ms16,
               prefix_hits=stats["hits"], peak_bytes=peak)
    log(f"/generate at full width: {len(reqs)} concurrent requests "
        f"(prompts {min(len(r['src']) for r in reqs)}-"
        f"{max(len(r['src']) for r in reqs)} tokens, 8 sharing "
        f"{GEN_SHARED_PREFIX}), {tokens} tokens in {burst_s:.3f} s = "
        f"{out['tokens_per_s']:.1f} tokens/s; time to first token p50 "
        f"{out['ttft_p50_ms']:.1f} ms p99 {out['ttft_p99_ms']:.1f} ms "
        f"(streamed); latency p50 {out['latency_p50_ms']:.1f} ms p99 "
        f"{out['latency_p99_ms']:.1f} ms; decode step at {DEC_SLOTS} slots "
        f"{ms16:.2f} ms median; prefix cache {stats}; peak memory "
        f"{peak / 2**30:.2f} GiB; {len(greedy)} greedy replies equal their "
        f"solo decode ({diverged} diverge at a near-tie); launches "
        f"{ {k: c for k, c in launches.items() if c} }; the stepper: "
        f"{split}; on {smi}")
    return out, launches, refs, reqs


def phase_spec(dev, model, refs, reqs, smi):
    """D. Speculative decoding on the same model: GenerationEngine(model,
    max_slots=16, spec_draft=NgramDraft(), spec_k=4) over the greedy
    requests of phase C; ids equal the solo references up to near-ties.
    Logs the acceptance ratio and tokens/s."""
    from paddle_tpu_torch.decode import GenerationEngine
    from paddle_tpu_torch.decode.spec import NgramDraft
    from paddle_tpu_torch.observability import metrics

    proposed = metrics.counter("decode_spec_proposed_total")
    accepted = metrics.counter("decode_spec_accepted_total")
    p0, a0 = proposed.value(), accepted.value()
    engine = GenerationEngine(model, max_slots=DEC_SLOTS,
                              max_new_tokens=GEN_NEW_TOKENS,
                              spec_draft=NgramDraft(), spec_k=4)
    before = stepper_time()
    try:
        t0 = time.perf_counter()
        handles = {i: engine.submit(reqs[i]["src"], GEN_NEW_TOKENS)
                   for i in refs}
        got = {i: h.result(timeout=900) for i, h in handles.items()}
        secs = time.perf_counter() - t0
    finally:
        engine.stop()
    diverged = sum(agrees(got[i], refs[i]) is not None for i in refs)
    if model.allocator.pages_in_use:
        fail(f"speculative decoding leaked {model.allocator.pages_in_use} "
             "pages")
    tokens = sum(len(x) for x in got.values())
    ratio = (accepted.value() - a0) / max(1.0, proposed.value() - p0)
    log(f"speculative decoding (n-gram draft, k 4): {len(got)} requests, "
        f"{tokens} tokens in {secs:.3f} s = {tokens / secs:.1f} tokens/s; "
        f"{int(accepted.value() - a0)} of {int(proposed.value() - p0)} "
        f"drafted tokens accepted (ratio {ratio:.3f}); ids equal the solo "
        f"greedy decode ({diverged} diverge at a near-tie); the stepper: "
        f"{stepper_split(before, secs)}; on {smi}")
    return dict(tokens_per_s=tokens / secs, accept_ratio=ratio)


def profile_decode_step():
    """The body of ``chip_smoke.py --profile-decode-step``: one profiled
    decode step of the full-width model at 16 active slots (seeded lens
    of 48-1056 rows, pools of seeded values), after 3 warm-up steps; one
    profiled cold prefill of a 600-token prompt and one prefix-hit
    prefill of it (512 cached rows); the cost of bringing the step's
    logits (16 x 32768 f32) to the host.  Prints {"idle_share",
    "step_ms", "d2h_ms"} as the last line."""
    import torch

    dev = torch.device("cuda", 0)
    model = decode_model()
    gen = torch.Generator(device=dev).manual_seed(81)
    model.k_pool.normal_(generator=gen)
    model.v_pool.normal_(generator=gen)
    rng = np.random.RandomState(82)
    lens = [int(x) for x in rng.randint(16, 1025, DEC_SLOTS) + 32]
    pages = [model.allocator.alloc(model.context_pages([0] * n, 1))
             for n in lens]
    tables = np.stack([model.pool_table(pg) for pg in pages])
    toks = rng.randint(2, DEC_CONFIG["vocab"], (DEC_SLOTS, 1))
    lens = np.asarray(lens, np.int64)

    def step():
        model.decode(toks, [], tables, lens)

    for _ in range(3):
        step()
    idle = profile_step(step, f"decode step at {DEC_SLOTS} slots",
                        want={"paged_attention_kernel":
                              DEC_CONFIG["num_layers"]})
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        step()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)
    prompt = [int(x) for x in rng.randint(2, DEC_CONFIG["vocab"],
                                          GEN_SHARED_PREFIX + 88)]
    cold = model.allocator.alloc(model.context_pages(prompt, 0))
    hit = model.allocator.fork(cold[:GEN_SHARED_PREFIX //
                                    DEC_CONFIG["page_size"]])
    hit += model.allocator.alloc(len(cold) - len(hit))
    layers = DEC_CONFIG["num_layers"]
    for what, run, want in (
            (f"cold prefill of {len(prompt)} tokens",
             lambda: model.prefill(prompt, cold),
             {"flash_fwd_tf32_kernel": layers}),
            (f"prefix-hit prefill ({GEN_SHARED_PREFIX} cached + 88)",
             lambda: model.prefill(prompt, hit, cached_len=GEN_SHARED_PREFIX),
             {"paged_chunk_split_kernel": layers,
              "paged_chunk_merge_kernel": layers})):
        run()
        profile_step(run, what, want=want)
        ptimes = []
        for _ in range(5):
            t0 = time.perf_counter()
            run()
            ptimes.append((time.perf_counter() - t0) * 1e3)
        log(f"{what}: {statistics.median(ptimes):.3f} ms median over 5 "
            "(host clock, the last row's logits on the host)")
    logits = torch.randn(DEC_SLOTS, DEC_CONFIG["vocab"], device=dev)
    d2h = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits.cpu().numpy()
        d2h.append((time.perf_counter() - t0) * 1e3)
    mib = DEC_SLOTS * DEC_CONFIG["vocab"] * 4 / 2**20
    log(f"decode step at {DEC_SLOTS} slots: {step_ms:.3f} ms median over "
        f"10 (host clock, logits on the host); the logits' copy to the host "
        f"({mib:.0f} MiB) {statistics.median(d2h):.3f} ms median")
    print(json.dumps({"idle_share": idle, "step_ms": step_ms,
                      "d2h_ms": statistics.median(d2h)}), flush=True)


# ---------------------------------------------------------------------------
# the image cells of benchmark/run.py: alexnet, googlenet, vgg16, smallnet
# ---------------------------------------------------------------------------


def build_image_program(name, is_test=False, seed=2026):
    """run.py's training program for an image cell (run.py:55-91), in the
    port: the model at its image size and classes, mean(cross_entropy),
    Momentum(0.01, 0.9); with ``is_test`` its dropouts are the identity
    (every other op trains).  Returns (main, startup, loss,
    params_grads)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import models

    _, image, classes, _ = IMAGE_CELLS[name]
    pt.framework.reset_default_programs()
    main_prog = pt.default_main_program()
    startup = pt.default_startup_program()
    main_prog.seed = startup.seed = seed
    img = pt.layers.data(name="img", shape=list(image))
    label = pt.layers.data(name="label", shape=[1], dtype="int64")
    if name == "smallnet":
        pred = models.resnet_cifar10(img, depth=20, class_dim=classes)
    else:
        pred = getattr(models, name)(img, class_dim=classes, is_test=is_test)
    loss = pt.layers.mean(pt.layers.cross_entropy(input=pred, label=label))
    _, params_grads = pt.optimizer.Momentum(
        learning_rate=IMAGE_LR, momentum=IMAGE_MOMENTUM).minimize(loss)
    return main_prog, startup, loss, params_grads


def forward_gflops_per_image(program):
    """The forward conv and fc GFLOP of one image, from the program's
    static shapes, counted as benchmark/flops.py:21-73 counts them: 2 x
    the multiply-adds of every conv2d and mul op."""
    block = program.global_block()
    total = 0.0
    for op in block.ops:
        if op.type == "conv2d":
            w = block.var(op.input("Filter")[0]).shape
            out = block.var(op.output("Output")[0]).shape
            total += 2.0 * math.prod(w) * out[2] * out[3]
        elif op.type == "mul":
            x = block.var(op.input("X")[0]).shape
            y = block.var(op.input("Y")[0]).shape
            ncol = op.attr("x_num_col_dims", 1)
            total += (2.0 * math.prod(x[1:ncol]) * math.prod(x[ncol:])
                      * math.prod(y[1:]))
    return total / 1e9


def phase_image_work_guard(programs):
    """Each image program's forward conv + fc GFLOP per image within
    FLOPS_RTOL of the architecture's published cost (IMAGE_CELLS): a
    graph doing the wrong amount of work (a stem that lost its stride)
    fails here, before any number is taken."""
    got = {}
    for name, (main_prog, *_) in programs.items():
        want = IMAGE_CELLS[name][3]
        got[name] = forward_gflops_per_image(main_prog)
        log(f"{name}: {got[name]:.4f} GFLOP a forward image (published "
            f"{want}, tolerance {FLOPS_RTOL:.0%})")
        if not abs(got[name] - want) <= FLOPS_RTOL * want:
            fail(f"{name} does {got[name]:.3f} GFLOP a forward image, not "
                 f"{want} +- {FLOPS_RTOL:.0%}")
    return got


def image_conv_launches(program, batch):
    """{"fwd" | "bwd" | "dw": {(n, h, w, c, o, k): count}}: the conv
    kernel's forward, backward-input and filter-gradient launches in one
    training step of ``program`` at ``batch`` rows (a conv on the image
    has no backward-input)."""
    block = program.global_block()
    out = {"fwd": {}, "bwd": {}, "dw": {}}
    for op in block.ops:
        if op.type == "conv2d" and _conv_kernel_op(op, block):
            kinds = ["fwd"]
        elif op.type == "conv2d_grad" and _conv_kernel_op(
                op, block, attrs=op.attr("__fwd_attrs__")):
            kinds = [k for k, slot in (("bwd", "Input@GRAD"),
                                       ("dw", "Filter@GRAD"))
                     if op.output(slot) and op.output(slot)[0]]
        else:
            continue
        x = block.var(op.input("Input")[0]).shape
        w = block.var(op.input("Filter")[0]).shape
        key = (batch, x[2], x[3], x[1], w[0], w[2])
        for kind in kinds:
            out[kind][key] = out[kind].get(key, 0) + 1
    return out


def conv_engine(kind, c, o, bf16):
    """The engine of a conv launch of ``kind`` with c input and o output
    channels, on 16-byte-aligned operands (every tensor the step hands the
    kernels): the rules of kernels/conv.py (the backward-input's C and O
    swapped)."""
    from paddle_tpu_torch.kernels import conv as kconv

    if kind == "dw":
        return (kconv.bf16_engine if bf16 else kconv.f32_dw_engine)(
            c, o, 0, 0)
    if kind == "bwd":
        c, o = o, c
    return (kconv.bf16_engine if bf16 else kconv.f32_engine)(c, o, 0, 0)


CONV_ROWS = {"fwd": "conv2d_nhwc", "bwd": "conv_bwd_input", "dw": "conv_dw"}


def wgmma_implied(program, amp):
    """The wgmma launches of one training step of ``program``, keyed as
    ``wgmma_counters()``: each conv launch by ``conv_engine``; the fcs'
    products (at most 256 rows) all on the tiles."""
    want = dict.fromkeys(wgmma_counters(), 0)
    for kind, shapes in image_conv_launches(program, 1).items():
        row = CONV_ROWS[kind] + ("_bf16" if amp else "")
        for (_, _, _, c, o, _), count in shapes.items():
            want[row] += count * (conv_engine(kind, c, o, amp) == "wgmma")
    return want


def _image_conv_calls(kind, x, wt, g, k, p):
    """(kernel, plain, library) calls of one conv launch of ``kind``."""
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input, conv2d_weight

    from paddle_tpu_torch.kernels import conv as kconv

    x_lib, g_lib = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    w_lib = wt.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    if kind == "fwd":
        return (lambda: kconv.conv2d_nhwc(x, wt, p),
                lambda: kconv.conv2d_nhwc_plain(x, wt, p),
                lambda: F.conv2d(x_lib, w_lib, padding=p))
    if kind == "bwd":
        return (lambda: kconv.conv2d_nhwc_bwd_input(g, wt, p),
                lambda: kconv.conv2d_nhwc_bwd_input_plain(g, wt, p),
                lambda: conv2d_input(x_lib.shape, w_lib, g_lib, padding=p))
    return (lambda: kconv.conv2d_nhwc_dw(x, g, k, p),
            lambda: kconv.conv2d_nhwc_dw_plain(x, g, k, p),
            lambda: conv2d_weight(x_lib, w_lib.shape, g_lib, padding=p))


def _image_model_convs(name, launches, dtype, randn):
    """One model's conv launches in ``dtype``: every distinct shape of
    each kind against its plain version (checked once; the plain version
    timed IMAGE_PLAIN_REPS times), CUDA-event medians of the kernel and
    the library call, the bound; summed over the step's launches, and
    apart by engine; then the step's launches of each kind once more in
    one profiled window, for their device time.  Returns {row: summary}."""
    import torch

    bf16 = dtype == torch.bfloat16
    size = 2 if bf16 else 4
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
    sfx = "_bf16" if bf16 else ""
    shapes = sorted(set().union(*launches.values()))
    tensors = {}
    for (n, h, w, c, o, k) in shapes:
        tensors[(n, h, w, c, o, k)] = (
            randn(n, h, w, c).to(dtype),
            randn(k, k, c, o, scale=(2.0 / (k * k * c)) ** 0.5).to(dtype),
            randn(n, h, w, o).to(dtype))
    out = {}
    for kind, counts in launches.items():
        row = CONV_ROWS[kind] + sfx
        total, calls = _Sum(peak), []
        by_engine = {}
        for key, count in sorted(counts.items()):
            n, h, w, c, o, k = key
            x, wt, g = tensors[key]
            kernel, plain, library = _image_conv_calls(kind, x, wt, g, k,
                                                       k // 2)
            tag = f"{name} {'bf16 ' if bf16 else ''}{kind} N{n} {h}x{w} " \
                  f"{c}->{o} k{k}"
            want = plain()
            got = kernel()
            if kind == "dw":
                err = check_scaled(tag, got, want, DW_TOL)
            elif bf16:
                err = check_bf16(tag, got, want)
            else:
                err = check_close(tag, got, want, **GEMM_TOL)
            del got, want
            times = (time_ms(kernel, reps=5),
                     time_ms(plain, reps=IMAGE_PLAIN_REPS, warmup=0),
                     time_ms(library, reps=5))
            flops = 2.0 * n * h * w * o * k * k * c
            nbytes = (size * (n * h * w * (c + o))
                      + (4 if kind == "dw" else size) * k * k * c * o)
            engine = conv_engine(kind, c, o, bf16)
            _line(f"{tag} ({engine})", count, *times, flops, nbytes, err,
                  peak)
            total.add(count, *times, flops, nbytes, err)
            e = by_engine.setdefault(engine, dict(launches=0, ms=0.0))
            e["launches"] += count
            e["ms"] += count * times[0]
            calls.append((kernel, count))

        def window(calls=calls):
            for fn, count in calls:
                for _ in range(count):
                    fn()

        r = total.result()
        r.update(device_ms=sum(device_ms(window, reps=1).values()),
                 launches=sum(counts.values()), engines=by_engine)
        log(f"  {name}'s {row} launches ({r['launches']}): kernel "
            f"{r['ms']:.3f} ms, device {r['device_ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}); by engine "
            + ", ".join(f"{e} {v['launches']} launches {v['ms']:.3f} ms"
                        for e, v in sorted(by_engine.items())))
        out[row] = r
    del tensors
    torch.cuda.empty_cache()
    return out


def _image_model_dense(name, program, batch, randn):
    """The fcs' forward products (the matmul kernel, f32 and bf16) and the
    head's softmax at the step's shapes, against their plain versions,
    with the library call and the bound.  Returns {row: summary}."""
    import torch

    from paddle_tpu_torch.kernels import matmul as kmatmul
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    out = {}
    for dtype, row in ((torch.float32, "matmul"),
                       (torch.bfloat16, "matmul_bf16")):
        bf16 = dtype == torch.bfloat16
        peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
        total = _Sum(peak)
        for (m, k, n), count in sorted(mul_shapes_of(program, batch).items()):
            x = randn(m, k).to(dtype)
            y = randn(k, n, scale=k ** -0.5).to(dtype)
            tag = f"{name} {'bf16 ' if bf16 else ''}matmul {m}x{k}x{n}"
            got, want = kmatmul.matmul(x, y), kmatmul.matmul_plain(x, y)
            err = (check_bf16(tag, got, want) if bf16
                   else check_close(tag, got, want, **GEMM_TOL))
            times = (time_ms(lambda: kmatmul.matmul(x, y), reps=5),
                     time_ms(lambda: kmatmul.matmul_plain(x, y),
                             reps=IMAGE_PLAIN_REPS, warmup=0),
                     time_ms(lambda: torch.matmul(x, y), reps=5))
            flops = 2.0 * m * k * n
            nbytes = (2 if bf16 else 4) * (m * k + k * n + m * n)
            engine = (kmatmul.bf16_engine if bf16 else kmatmul.f32_engine)(
                m, k, n, x.data_ptr(), y.data_ptr())
            _line(f"{tag} ({engine})", count, *times, flops, nbytes, err,
                  peak)
            total.add(count, *times, flops, nbytes, err)
        out[row] = total.result()
    classes = IMAGE_CELLS[name][2]
    x = randn(batch, classes, scale=4.0)
    err = check_close(f"{name} softmax {batch}x{classes}",
                      ksoftmax.softmax(x), ksoftmax.softmax_plain(x),
                      rtol=0, atol=SOFTMAX_ATOL)
    times = (time_ms(lambda: ksoftmax.softmax(x), reps=5),
             time_ms(lambda: ksoftmax.softmax_plain(x), reps=5),
             time_ms(lambda: torch.softmax(x, dim=-1), reps=5))
    b_ms, b_by = bound(5.0 * batch * classes, 8.0 * batch * classes)
    _line(f"{name} softmax {batch}x{classes}", 1, *times,
          5.0 * batch * classes, 8.0 * batch * classes, err)
    out["softmax"] = dict(ms=times[0], plain_ms=times[1],
                          library_ms=times[2], bound_ms=b_ms, bound_by=b_by,
                          max_abs_err=err)
    return out


def _image_model_bn(name, program, batch, randn):
    """The BN forward and backward at every distinct BN shape of the step,
    in each dtype a cell runs it (float32 after VGG-16's bias adds in both
    cells; bf16 too under AMP where X is a conv's output), against their
    plain versions, with the library call (F.batch_norm and
    native_batch_norm_backward on channels-last tensors) and the bound.
    Returns {row: summary}."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import batch_norm as kbn

    block = program.global_block()
    shapes = bn_shapes_of(program, batch)
    if not shapes:
        return {}
    dtypes = [torch.float32]
    if any(bn_input_is_conv(op, block) for op in block.ops
           if op.type == "batch_norm"):
        dtypes.append(torch.bfloat16)
    out = {}
    for dtype in dtypes:
        bf16 = dtype == torch.bfloat16
        size, sfx = (2, "_bf16") if bf16 else (4, "")
        peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
        sums = {"fwd": _Sum(peak), "bwd": _Sum(peak)}
        for (n, h, w, c), count in sorted(shapes.items()):
            rows = n * h * w
            x = (randn(rows, c, scale=2.0) + 0.5).to(dtype)
            dy = randn(rows, c).to(dtype)
            gamma, beta = randn(c), randn(c)
            x4 = x.reshape(n, h, w, c).permute(0, 3, 1, 2)
            dy4 = dy.reshape(n, h, w, c).permute(0, 3, 1, 2)
            tag = f"{name} {'bf16 ' if bf16 else ''}bn R{rows} C{c}"

            def close(what, got, want):
                return (check_bf16(what, got, want) if bf16
                        else check_close(what, got, want, **BN_TOL))

            y, m, v = kbn.batch_norm_fwd(x, gamma, beta, BN_EPS)
            py, pm, pv = kbn.batch_norm_fwd_plain(x, gamma, beta, BN_EPS)
            err_f = close(f"{tag} fwd", y, py)
            check_scaled(f"{tag} mean", m, pm, BN_VEC_TOL)
            check_scaled(f"{tag} var", v, pv, BN_VEC_TOL)
            inv = torch.rsqrt(v + BN_EPS)
            dx, dg, db = kbn.batch_norm_bwd(x, dy, gamma, m, inv)
            pdx, pdg, pdb = kbn.batch_norm_bwd_plain(x, dy, gamma, m, inv)
            err_b = close(f"{tag} bwd", dx, pdx)
            check_scaled(f"{tag} dgamma", dg, pdg, BN_VEC_TOL)
            check_scaled(f"{tag} dbeta", db, pdb, BN_VEC_TOL)
            del y, py, dx, pdx
            for d, err, flops, nbytes, fns in (
                    ("fwd", err_f, 5.0 * rows * c, 2.0 * rows * c * size, (
                        lambda: kbn.batch_norm_fwd(x, gamma, beta, BN_EPS),
                        lambda: kbn.batch_norm_fwd_plain(x, gamma, beta,
                                                         BN_EPS),
                        lambda: F.batch_norm(x4, None, None, gamma, beta,
                                             training=True, eps=BN_EPS))),
                    ("bwd", err_b, 8.0 * rows * c, 3.0 * rows * c * size, (
                        lambda: kbn.batch_norm_bwd(x, dy, gamma, m, inv),
                        lambda: kbn.batch_norm_bwd_plain(x, dy, gamma, m,
                                                         inv),
                        lambda: torch.ops.aten.native_batch_norm_backward(
                            dy4, x4, gamma, None, None, m, inv, True,
                            BN_EPS, [True, True, True])))):
                times = (time_ms(fns[0], reps=5),
                         time_ms(fns[1], reps=IMAGE_PLAIN_REPS, warmup=0),
                         time_ms(fns[2], reps=5))
                _line(f"{tag} {d} ({kbn.route(c, dtype, x.data_ptr())})", count, *times, flops,
                      nbytes, err, peak)
                sums[d].add(count, *times, flops, nbytes, err)
            del x, dy, x4, dy4
        for d, row in (("fwd", "batch_norm_fwd"), ("bwd", "batch_norm_bwd")):
            out[row + sfx] = sums[d].result()
    torch.cuda.empty_cache()
    return out


def phase_image_kernels(dev, programs):
    """Phase 2 at the image cells' shapes: every kernel-route conv shape of
    the four steps at run.py's batch (forward, backward-input, filter
    gradient; float32 and bf16) against its plain version on the engine
    the rules pick, the fcs' products and the heads' softmax, and the BN
    at VGG-16's and smallnet's shapes; each model's launches summed.
    Returns {model: {kernels-line row: summary}}."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(4321)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    results = {}
    for name, (main_prog, *_) in programs.items():
        batch = IMAGE_CELLS[name][0]
        launches = image_conv_launches(main_prog, batch)
        log(f"{name} at batch {batch}: conv kernel launches a step "
            + ", ".join(f"{k} {sum(v.values())} ({len(v)} shapes)"
                        for k, v in launches.items())
            + f" (plain versions timed {IMAGE_PLAIN_REPS} times):")
        res = {}
        for dtype in (torch.float32, torch.bfloat16):
            res.update(_image_model_convs(name, launches, dtype, randn))
        res.update(_image_model_dense(name, main_prog, batch, randn))
        res.update(_image_model_bn(name, main_prog, batch, randn))
        results[name] = res
    return results


def phase_image_parity(dev, name):
    """An image cell's step at PARITY_BATCH on the card against the same
    step on CPUPlace() from identical weights, its dropouts ``is_test``
    (the two devices draw different masks) and every other op training:
    float32 (phase 5's tolerances, end to end and op by op) and AMP (phase
    6b's)."""
    main_prog, startup, loss, params_grads = build_image_program(
        name, is_test=True)
    _, image, classes, _ = IMAGE_CELLS[name]
    phase_train_parity(dev, main_prog, startup, loss, params_grads, image,
                       classes, what=f"{name} step")
    phase_amp_parity(dev, main_prog, startup, loss, image, classes,
                     what=f"{name} AMP step")


def _dropout_on_card(dev, shape, p, dtype, models):
    """One training dropout at ``shape`` in ``dtype`` on the card, in a
    program of its own (dropout, then mean): Out == X * Mask and X@GRAD
    == Out@GRAD * Mask bit for bit, the mask's values {0, 1 / (1 - p) in
    the dtype} and nothing else, the kept share within
    IMAGE_DROPOUT_SIGMAS sigma of 1 - p; a second Executor's first step
    draws the same mask, the next step another."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.backward import append_backward
    from paddle_tpu_torch.layer_helper import LayerHelper

    main_prog, startup = pt.Program(), pt.Program()
    main_prog.seed = startup.seed = 99
    with pt.program_guard(main_prog, startup):
        x = pt.layers.data(name="x", shape=list(shape[1:]), dtype=dtype)
        x.stop_gradient = False
        out = pt.layers.dropout(x, dropout_prob=p)
        out_f32 = out
        if dtype != "float32":
            helper = LayerHelper("cast")
            out_f32 = helper.create_tmp_variable("float32", out.shape)
            helper.append_op(type="cast", inputs={"X": [out]},
                             outputs={"Out": [out_f32]},
                             attrs={"out_dtype": "float32",
                                    "in_dtype": dtype})
        append_backward(pt.layers.mean(out_f32))
    mask = main_prog.global_block().ops[0].output("Mask")[0]
    tdt = getattr(torch, dtype)
    xv = torch.randn(*shape, device=dev).to(tdt)
    fetch = [out.name, mask, "x@GRAD", out.name + "@GRAD"]
    masks = []
    for exe_i in range(2):
        exe = pt.Executor()
        for step in range(2 - exe_i):
            o, m, gx, go = exe.run(main_prog, feed={"x": xv},
                                   fetch_list=fetch, scope=pt.Scope(),
                                   return_numpy=False)
            masks.append(m)
            if not (torch.equal(o, xv * m) and torch.equal(gx, go * m)):
                fail(f"dropout {shape} {dtype}: Out != X * Mask or X@GRAD "
                     "!= Out@GRAD * Mask")
            q = float(torch.ones((), dtype=tdt) / torch.tensor(1 - p,
                                                               dtype=tdt))
            vals = set(torch.unique(m.float()).tolist())
            kept = float((m != 0).float().mean())
            sigma = (p * (1 - p) / m.numel()) ** 0.5
            if vals != {0.0, q} or not abs(kept - (1 - p)) <= \
                    IMAGE_DROPOUT_SIGMAS * sigma:
                fail(f"dropout {shape} {dtype}: mask values {vals} (want "
                     f"{{0, {q}}}), kept share {kept} (want {1 - p} +- "
                     f"{IMAGE_DROPOUT_SIGMAS} x {sigma:.2e})")
    if not torch.equal(masks[0], masks[2]) or torch.equal(masks[0],
                                                          masks[1]):
        fail(f"dropout {shape} {dtype}: the same step of two Executors drew "
             "different masks, or two steps the same one")
    log(f"  dropout p {p} at {tuple(shape)} {dtype} ({', '.join(models)}): "
        f"Out = X * Mask, X@GRAD = Out@GRAD * Mask, mask values {{0, {q}}},"
        f" kept {kept:.5f} (1 - p = {1 - p}, sigma {sigma:.1e}); the same "
        "step of a second Executor draws the same mask, the next step "
        "another")


def phase_image_dropout(dev, programs):
    """Training dropout on the card at each dropout's full-batch shape of
    the image steps, float32 (what both cells hand it: the fc and the
    pooled conv outputs are float32 after their bias adds) and bf16."""
    shapes = {}
    for name, (main_prog, *_) in programs.items():
        block = main_prog.global_block()
        for op in block.ops:
            if op.type == "dropout":
                shape = ((IMAGE_CELLS[name][0],)
                         + tuple(block.var(op.input("X")[0]).shape[1:]))
                shapes.setdefault((shape, op.attr("dropout_prob")),
                                  []).append(name)
    for (shape, p), models in sorted(shapes.items()):
        for dtype in ("float32", "bfloat16"):
            _dropout_on_card(dev, shape, p, dtype, sorted(set(models)))


def phase_image_step(dev, name, smi, amp=False):
    """An image cell's training step at run.py's batch (under AMP with
    ``amp``), dropout on: counted launches against ``launches_implied``
    and each engine's share against ``wgmma_implied``, images/s over 5
    timed steps after 2 warm-up steps, peak memory (it must fit the card),
    one profiled step, a finite loss."""
    import paddle_tpu_torch as pt

    main_prog, startup, loss, _ = build_image_program(name)
    with pt.amp.amp_guard(amp):
        return _image_step(dev, name, main_prog, startup, loss,
                           IMAGE_CELLS[name][0], smi,
                           "AMP bf16" if amp else "f32", amp)


def _image_step(dev, name, main_prog, startup, loss, batch, smi, kind, amp):
    import torch

    import paddle_tpu_torch as pt

    _, image, classes, _ = IMAGE_CELLS[name]
    want = launches_implied(main_prog, amp=amp)
    want_wgmma = wgmma_implied(main_prog, amp)
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    gen = torch.Generator(device=dev).manual_seed(12)
    feed = {"img": torch.randn(batch, *image, device=dev, generator=gen),
            "label": torch.randint(0, classes, (batch, 1), device=dev,
                                   generator=gen)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    t0 = time.perf_counter()
    (first,) = exe.run(main_prog, feed=feed, fetch_list=[loss], scope=scope)
    first_s = time.perf_counter() - t0
    launches = counters()
    wgmma = wgmma_counters()
    log(f"first {name} {kind} train step at batch {batch}: loss "
        f"{float(first):.5f} in {first_s:.2f} s; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    if launches != want:
        fail(f"{name} {kind} step: launch counts {launches} != {want}")
    if wgmma != want_wgmma:
        fail(f"{name} {kind} step: wgmma launch counts {wgmma} != "
             f"{want_wgmma}")
    shares = {row: (wgmma[row], launches[row]) for row in wgmma
              if launches[row]}
    log(f"  {name} {kind}: launches on the wgmma engine / all, by kernel: "
        + ", ".join(f"{row} {w}/{n} ({w / n:.0%})"
                    for row, (w, n) in shares.items()))
    (second,) = exe.run(main_prog, feed=feed, fetch_list=[loss], scope=scope)
    times, losses = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        (val,) = exe.run(main_prog, feed=feed, fetch_list=[loss], scope=scope)
        times.append(time.perf_counter() - t0)   # numpy fetch: a device sync
        losses.append(float(val))
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite([float(first), float(second)] + losses)):
        fail(f"{name} {kind}: non-finite training loss: {first}, {second}, "
             f"{losses}")
    img_s = 5 * batch / sum(times)
    log(f"{name} train step at batch {batch} ({kind}): {img_s:.1f} images/s "
        f"over 5 timed steps after 2 warm-up steps ({sum(times):.3f} s; "
        f"median {statistics.median(times) * 1e3:.1f} ms, min "
        f"{min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f}); losses "
        f"{[round(x, 5) for x in losses]}; peak memory allocated "
        f"{peak / 2**30:.2f} GiB on {smi}")
    idle = profile_step(
        lambda: exe.run(main_prog, feed=feed, fetch_list=[loss],
                        scope=scope),
        f"{name} {kind} train step",
        want={"wgmma_dw_kernel": want_wgmma["conv_dw_bf16"],
              "wgmma_tf32_dw_kernel": want_wgmma["conv_dw"]})
    del exe, scope, feed
    torch.cuda.empty_cache()
    return dict(images_per_s=img_s, peak_bytes=peak, idle_share=idle,
                launches=launches, wgmma=wgmma, shares=shares, batch=batch)


def phase_decode_profile():
    """F. One profiled decode step in a fresh process (this script with
    PROFILE_DEC), as phase 16 profiles the sequence steps."""
    return profile_in_child(PROFILE_DEC, "decode step")


# ---------------------------------------------------------------------------
# the v1 demos and the fluid demos
# ---------------------------------------------------------------------------


class _StampedLines:
    """A stdout stand-in that keeps each line with the time it was
    written (the trainer's "Pass p, Batch b, Cost c" lines come at each
    EndIteration, after its cost reached the host)."""

    def __init__(self):
        self.lines, self._part = [], ""

    def write(self, text):
        self._part += text
        *done, self._part = self._part.split("\n")
        now = time.perf_counter()
        self.lines += [(now, line) for line in done]
        return len(text)

    def flush(self):
        pass


def _trainer_cli(args):
    """paddle_tpu_torch.trainer.main(args) with its output kept:
    (exit code, [(time, line)])."""
    import contextlib

    from paddle_tpu_torch.trainer import trainer as pt_trainer

    out = _StampedLines()
    with contextlib.redirect_stdout(out):
        rc = pt_trainer.main(args)
    return rc, out.lines


def _demo_cpu_costs(config, init_tar, steps=2):
    """The config's first ``steps`` batches trained on CPUPlace() from
    the weights in ``init_tar``: their costs."""
    import itertools

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.trainer.config_parser import parse_config
    from paddle_tpu_torch.trainer.trainer import Trainer

    pt.framework.reset_default_programs()
    t = Trainer(parse_config(config), pt.CPUPlace())
    t.load_parameters(init_tar)
    reader = t._reader_from_sources()
    costs = []
    t._sgd.train(lambda: itertools.islice(reader(), steps),
                 event_handler=lambda e: costs.append(e.cost)
                 if hasattr(e, "cost") else None)
    return costs


def _check_first_steps(what, got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        if abs(g - w) > PARITY_TOL * abs(w):
            fail(f"{what}: step {i} cost {g:.6f} on the card, {w:.6f} on "
                 f"the CPU (gate {PARITY_TOL} of it)")


def _demo_record(what, launches, steps, samples, seconds, smi):
    """The launches, ms a step, samples/s and peak memory of a demo run,
    logged; the record returned."""
    import torch

    rec = dict(launches=launches, steps=steps,
               ms_per_step=1e3 * seconds / max(steps, 1),
               samples_per_s=samples / seconds,
               peak_bytes=torch.cuda.max_memory_allocated())
    log(f"{what}: launches { {k: v for k, v in launches.items() if v} }; "
        f"{rec['ms_per_step']:.3f} ms a step, {rec['samples_per_s']:.1f} "
        f"samples/s over {steps} steps, peak "
        f"{rec['peak_bytes'] / 2**30:.3f} GiB; on {smi}")
    return rec


def phase_v1_demos(dev, smi):
    """The v1 demos on the card through the command line a user runs.
    For each: its config's initial weights (CPUPlace()) as a params.tar;
    the first two batches on CPUPlace() from them; then ``main(["--config",
    ..., "--init_model_path", tar, "--num_passes", n, "--log_period=1",
    "--save_dir", d])`` on the card, the counters zeroed just before and
    read just after.  The first two costs within PARITY_TOL of the CPU's,
    the costs to the reference test's gate (V1_DEMOS), then ``--job=test``
    on the last pass directory (a finite cost under the first training
    cost).  ms a step between the first and the last batch's line,
    samples/s, peak memory.  Then ``--job=checkgrad`` on
    traffic_prediction on the card."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.trainer.config_parser import parse_config
    from paddle_tpu_torch.trainer.trainer import Trainer

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (passes, gate, gate_text) in V1_DEMOS.items():
            config = os.path.join(HERE, "paddle_tpu_torch", "demos", name,
                                  "trainer_config.py")
            pt.framework.reset_default_programs()
            t = Trainer(parse_config(config), pt.CPUPlace())
            init_tar = os.path.join(tmp, f"{name}_init.tar")
            with open(init_tar, "wb") as f:
                t.parameters.to_tar(f)
            batch = t.batch_size
            del t
            want = _demo_cpu_costs(config, init_tar)
            save = os.path.join(tmp, name)
            pt.framework.reset_default_programs()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counters()
            rc, lines = _trainer_cli([
                f"--config={config}", f"--init_model_path={init_tar}",
                f"--num_passes={passes}", "--log_period=1",
                f"--save_dir={save}"])
            launches = counters()
            steps = [(ts, float(line.split("Cost ")[1].split(",")[0]))
                     for ts, line in lines if line.startswith("Pass ")]
            costs = [c for _, c in steps]
            if rc != 0 or len(costs) < 3:
                fail(f"v1 demo {name}: exit {rc}, {len(costs)} batches")
            _check_first_steps(f"v1 demo {name}", costs[:2], want)
            if not (np.isfinite(costs).all() and gate(costs)):
                fail(f"v1 demo {name}: costs {costs[0]:.6f} ... "
                     f"{costs[-3:]} miss the reference's gate ({gate_text})")
            seconds = steps[-1][0] - steps[0][0]
            rec = _demo_record(
                f"v1 demo {name} ({passes} passes, batch {batch})", launches,
                len(costs) - 1, batch * (len(costs) - 1), seconds, smi)
            rc, lines = _trainer_cli([
                "--job=test", f"--config={config}",
                f"--init_model_path={save}/pass-{passes - 1:05d}"])
            done = [line for _, line in lines if line.startswith("Test done")]
            test_cost = float(done[-1].split("cost")[-1].split(",")[0]) \
                if rc == 0 and done else float("nan")
            if not test_cost < costs[0]:
                fail(f"v1 demo {name} --job=test: cost {test_cost} (first "
                     f"training cost {costs[0]:.6f})")
            log(f"v1 demo {name}: costs {costs[0]:.6f} -> "
                f"{np.mean(costs[-3:]):.6f} (gate: {gate_text}), first two "
                f"{costs[:2]} on the card, {[round(w, 6) for w in want]} on "
                f"the CPU; --job=test on pass {passes - 1}: cost "
                f"{test_cost:.6f}")
            rec.update(first_cost=costs[0], last_costs=costs[-3:],
                       test_cost=test_cost)
            results[name] = rec
    traffic = os.path.join(HERE, "paddle_tpu_torch", "demos",
                           "traffic_prediction", "trainer_config.py")
    pt.framework.reset_default_programs()
    rc, lines = _trainer_cli(["--job=checkgrad", f"--config={traffic}"])
    text = [line for _, line in lines]
    if rc != 0 or not any("Gradient check PASSED" in x for x in text):
        fail(f"v1 demo traffic_prediction --job=checkgrad: {text[-3:]}")
    log("v1 demo traffic_prediction --job=checkgrad on the card: "
        + "; ".join(x for x in text if x.startswith("checkgrad")))
    return results


def _fluid_two_steps(what, program, startup, feeds, fetch):
    """Two steps of ``program`` on the card and on CPUPlace() from the
    same initial state (its startup run on the CPU): each fetch within
    PARITY_TOL of the CPU's value."""
    import paddle_tpu_torch as pt

    cpu, card = pt.Scope(), pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=cpu)
    card.load_numpy({n: v.numpy() for n, v in cpu.values.items()}, "cuda")
    for i, feed in enumerate(feeds):
        want = pt.Executor(pt.CPUPlace()).run(program, feed=feed,
                                              fetch_list=fetch, scope=cpu)
        got = pt.Executor().run(program, feed=feed, fetch_list=fetch,
                                scope=card)
        _check_first_steps(f"{what} {fetch}", [float(g) for g in got],
                           [float(w) for w in want])
        log(f"{what} step {i}: card {[float(g) for g in got]}, CPU "
            f"{[float(w) for w in want]}")


def phase_fluid_demos(dev, smi):
    """gan (DEMO_STEPS steps), vae (DEMO_STEPS) and model_zoo (10 steps,
    export, reload) on the card through their ``main(place=...)``, the
    counters zeroed just before each and read just after, each held to
    its reference test's gate (tests/test_demos.py).  gan's and
    model_zoo's first two steps against CPUPlace() from the same state;
    vae draws its noise in the graph from each place's own generator, so
    it is held by its gate only.  model_zoo's export reloaded on the card
    and on CPUPlace(): the probabilities within PROBS_TOL."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.demos.gan import train as gan
    from paddle_tpu_torch.demos.model_zoo import infer as zoo
    from paddle_tpu_torch.demos.vae import train as vae

    results = {}
    # gan: the first two steps, then the run
    pt.framework.reset_default_programs()
    zname, rname, _, d_loss, g_loss = gan.build()
    rng = np.random.RandomState(0)
    _fluid_two_steps("gan", pt.default_main_program(),
                     pt.default_startup_program(),
                     [{zname: rng.randn(64, 8).astype(np.float32),
                       rname: gan.real_batch(rng, 64)} for _ in range(2)],
                     [d_loss.name, g_loss.name])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    t0 = time.perf_counter()
    dl, gl, samples = gan.main(steps=DEMO_STEPS, verbose=False)
    seconds = time.perf_counter() - t0
    launches = counters()
    radius = float(np.linalg.norm(samples, axis=1).mean())
    real = float(np.linalg.norm(gan.real_batch(np.random.RandomState(0),
                                               256), axis=1).mean())
    if not (np.isfinite(dl) and np.isfinite(gl) and 1.0 < radius < 3.5
            and abs(radius - real) < 1.5):
        fail(f"gan: d {dl}, g {gl}, mean radius {radius} (real {real})")
    log(f"gan: d_loss {dl:.4f}, g_loss {gl:.4f}, mean radius {radius:.4f} "
        f"(real {real:.4f}; gate 1.0-3.5, within 1.5)")
    results["gan"] = _demo_record(f"gan ({DEMO_STEPS} steps, batch 64)",
                                  launches, DEMO_STEPS, 64 * DEMO_STEPS,
                                  seconds, smi)
    # vae
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    t0 = time.perf_counter()
    first, last = vae.main(steps=DEMO_STEPS, verbose=False)
    seconds = time.perf_counter() - t0
    launches = counters()
    if not last < 0.3 * first:
        fail(f"vae: reconstruction {first} -> {last} (gate 0.3 x)")
    log(f"vae: reconstruction {first:.4f} -> {last:.4f} (gate < 0.3 x)")
    results["vae"] = _demo_record(f"vae ({DEMO_STEPS} steps, batch 64)",
                                  launches, DEMO_STEPS, 64 * DEMO_STEPS,
                                  seconds, smi)
    # model_zoo: the first two steps, then export on the card and reload
    with tempfile.TemporaryDirectory() as tmp:
        protos = zoo.export(os.path.join(tmp, "build"), steps=0,
                            verbose=False, place=pt.CPUPlace())
        loss = next(op.output("Out")[0] for op in
                    pt.default_main_program().global_block().ops
                    if op.type == "mean")
        rng = np.random.RandomState(0)
        rng.randn(10, 3, 32, 32)   # the prototypes
        feeds = []
        for _ in range(2):
            ys = rng.randint(0, 10, (32,)).astype("int64")
            xs = protos[ys] + 0.1 * rng.randn(32, 3, 32, 32).astype(
                "float32")
            feeds.append({"img": xs, "label": ys.reshape(-1, 1)})
        _fluid_two_steps("model_zoo", pt.default_main_program(),
                         pt.default_startup_program(), feeds, [loss])
        model_dir = os.path.join(tmp, "resnet20")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        t0 = time.perf_counter()
        with pt.scope_guard(pt.Scope()):
            protos = zoo.export(model_dir, verbose=False)
        probs = zoo.infer(model_dir, protos)
        seconds = time.perf_counter() - t0
        launches = counters()
        want = zoo.infer(model_dir, protos, pt.CPUPlace())
    if probs.shape != (10, 10) or not np.allclose(probs.sum(1), 1.0,
                                                  atol=1e-4):
        fail(f"model_zoo: probabilities {probs.shape}, row sums "
             f"{probs.sum(1)}")
    if not np.allclose(probs, want, **PROBS_TOL):
        fail(f"model_zoo: reloaded probabilities on the card differ from "
             f"the CPU's by {np.abs(probs - want).max():.3e} ({PROBS_TOL})")
    log(f"model_zoo: top-1 of the prototypes {probs.argmax(1).tolist()}, "
        f"max |card - CPU| {np.abs(probs - want).max():.3e}")
    results["model_zoo"] = _demo_record(
        "model_zoo (10 steps at batch 32, export, reload, 10 images)",
        launches, 10, 32 * 10, seconds, smi)
    return results


# ---------------------------------------------------------------------------
# phases 15k-15n: LoD control flow, BN layouts and beams
# ---------------------------------------------------------------------------


def _card_feed(feed, dev):
    """A numpy feed (LoD values as (array, [offsets])) as tensors on the
    card, so a timed run copies nothing from the host."""
    import torch

    from paddle_tpu_torch.lod import create_lod_array

    return {k: create_lod_array(torch.from_numpy(v[0]).to(dev), v[1])
            if isinstance(v, tuple) else torch.from_numpy(v).to(dev)
            for k, v in feed.items()}


def _cpu_and_card_scopes(startup, dev):
    """The startup run on CPUPlace(), and its parameters copied to the
    card (``params_from_numpy``): (CPU scope, card scope)."""
    import paddle_tpu_torch as pt

    cpu, card = pt.Scope(), pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=cpu)
    card.values.update(pt.params_from_numpy(
        {n: v.numpy() for n, v in cpu.values.items()}, dev))
    return cpu, card


def phase_while_rnn(dev, smi):
    """15k (A): the While-driven dynamic RNN (``build_while_rnn``) at the
    LoD cell's widths, inference.  The parameters from the port's CPU
    startup copied to the card; the card's LoD rows, pooled values and
    head within WHILE_TOL of max|CPU| (the LoD offsets exactly).  The
    counters zeroed just before the first run and read just after: the
    gather 1, matmul 2 an iteration (the fc over [x_t, h] in the loop)
    plus 1 (the head), softmax 1, nothing else; the condition read on the
    host once an iteration and once more.  ms a batch (median of 5 after
    2 warm-ups), peak memory."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import control_flow_ops

    main_prog, startup, rows, pooled, pred = build_while_rnn(pt)
    feed = {"ids": lod_feed(np.random.RandomState(12))["ids"]}
    lens = np.diff(feed["ids"][1][0])
    iters = int(lens.max())
    fetch = [rows, pooled, pred]
    cpu, card = _cpu_and_card_scopes(startup, dev)
    want = pt.Executor(pt.CPUPlace()).run(main_prog, feed=feed,
                                          fetch_list=fetch, scope=cpu)
    exe = pt.Executor()
    card_feed = _card_feed(feed, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    reads = control_flow_ops.condition_reads
    got = exe.run(main_prog, feed=card_feed, fetch_list=fetch, scope=card)
    launches = counters()
    reads = control_flow_ops.condition_reads - reads
    expect = dict.fromkeys(KERNELS, 0)
    expect.update(embedding=1, matmul=2 * iters + 1, softmax=1)
    what = (f"While dynamic RNN, {LOD_SEQS} sequences of {int(lens.sum())} "
            f"rows, {iters} iterations")
    log(f"{what}: launches {launches}; condition reads {reads}")
    if launches != expect:
        fail(f"{what}: launch counts {launches} != {expect}")
    if reads != iters + 1:
        fail(f"{what}: {reads} host reads of the condition, not {iters + 1}")
    if not np.array_equal(got[0].lod[0], want[0].lod[0]):
        fail(f"{what}: the rebuilt rows' offsets differ from the CPU's")
    errs = {}
    for name, g_, w_ in zip(("rows", "pooled", "head"),
                            [got[0].data] + got[1:], [want[0].data] + want[1:]):
        err = float(np.abs(g_ - w_).max())
        scale = float(np.abs(w_).max())
        if not (np.isfinite(g_).all() and err <= WHILE_TOL * scale):
            fail(f"{what}: {name} max abs err {err:.3e} > {WHILE_TOL} * "
                 f"max|CPU| {scale:.3e}")
        errs[name] = err
    ms, times = time_ms(lambda: exe.run(main_prog, feed=card_feed,
                                        fetch_list=[pred], scope=card),
                        reps=5, all_times=True)
    peak = torch.cuda.max_memory_allocated()
    log(f"{what}: card vs CPU max abs err {errs} (tolerance {WHILE_TOL} of "
        f"max); {ms:.3f} ms a batch (median of 5 after 2 warm-ups; "
        f"{[round(t, 3) for t in times]}), {ms / iters:.3f} ms an iteration,"
        f" {reads / (ms / 1e3):.1f} condition reads/s; peak memory "
        f"allocated {peak / 2**30:.3f} GiB on {smi}")
    return dict(launches=launches, iterations=iters, condition_reads=reads,
                ms=ms, peak_bytes=peak, lens=lens)


def phase_ifelse_attention(dev, smi):
    """15l (B): the IfElse attention classifier (``build_ifelse_attention``)
    trained at the LoD cell's widths: ATTN_STEPS Adam(ATTN_LR) steps over
    ATTN_BATCHES seeded batches (``attention_feed``) in turn.  The first
    two costs within ATTN_COST_TOL (relative) of the port's CPU path from
    the same start; the mean of the last 5 costs under the mean of the
    first 5.  The counters zeroed just before the first step and read
    just after: the gather 1, matmul 4 (the fc over the rows on the wgmma
    engine; the score, N 1, and the two branches' fcs on the SIMT tile),
    nothing else.  ms a step, samples/s, peak memory."""
    import torch

    import paddle_tpu_torch as pt

    main_prog, startup, loss = build_ifelse_attention(pt, lr=ATTN_LR)
    rng = np.random.RandomState(14)
    batches = [attention_feed(rng) for _ in range(ATTN_BATCHES)]
    cpu, card = _cpu_and_card_scopes(startup, dev)
    want = [float(pt.Executor(pt.CPUPlace()).run(
        main_prog, feed=batches[i], fetch_list=[loss], scope=cpu)[0])
        for i in range(2)]
    expect = dict.fromkeys(KERNELS, 0)
    expect.update(embedding=1, matmul=4)
    if launches_implied(main_prog) != expect:
        fail(f"IfElse attention: the program implies "
             f"{launches_implied(main_prog)}, not {expect}")
    exe = pt.Executor()
    feeds = [_card_feed(b, dev) for b in batches]
    rows = int(feeds[0]["ids"].data.shape[0])
    what = f"IfElse attention step, {LOD_SEQS} sequences of {rows} rows"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    costs = [float(exe.run(main_prog, feed=feeds[0], fetch_list=[loss],
                           scope=card)[0])]
    launches, wgmma = counters(), wgmma_counters()
    log(f"{what}: launches {launches}; on the wgmma engine {wgmma}")
    if launches != expect or wgmma["matmul"] != 1:
        fail(f"{what}: launch counts {launches} (wgmma {wgmma}) != "
             f"{expect} with 1 matmul on the wgmma engine")
    times = []
    for i in range(1, ATTN_STEPS):
        t0 = time.perf_counter()
        (c,) = exe.run(main_prog, feed=feeds[i % ATTN_BATCHES],
                       fetch_list=[loss], scope=card)
        times.append((time.perf_counter() - t0) * 1e3)
        costs.append(float(c))
    peak = torch.cuda.max_memory_allocated()
    for i in range(2):
        if not abs(costs[i] - want[i]) <= ATTN_COST_TOL * abs(want[i]):
            fail(f"{what}: step {i} cost {costs[i]:.7f} on the card, "
                 f"{want[i]:.7f} on the CPU (gate {ATTN_COST_TOL} of it)")
    if not (np.isfinite(costs).all()
            and np.mean(costs[-5:]) < np.mean(costs[:5])):
        fail(f"{what}: costs do not fall: {costs}")
    ms = statistics.median(times[2:])
    log(f"{what}: first two costs {costs[:2]} on the card, {want} on the "
        f"CPU; costs {[round(c, 5) for c in costs]}; {ms:.3f} ms a step "
        f"(median of steps 3-{ATTN_STEPS - 1}), {LOD_SEQS / ms * 1e3:.1f} "
        f"samples/s; peak memory allocated {peak / 2**30:.3f} GiB on {smi}")
    return dict(launches=launches, wgmma=wgmma, ms_per_step=ms,
                samples_per_s=LOD_SEQS / ms * 1e3, peak_bytes=peak,
                costs=costs)


def build_bn_program(pt, shape, layout, lengths=False):
    """A training BN over ``shape`` in ``layout`` (on sequence frames
    (B, T, C) with ``lengths``), sum(Y * G) as the loss and its
    backward.  Returns (main, startup, fetch: Y, dX, dScale, dBias)."""
    pt.framework.reset_default_programs()
    x = pt.layers.data(name="x", shape=list(shape), dtype="float32",
                       append_batch_size=False)
    x.stop_gradient = False
    lens = (pt.layers.data(name="len", shape=[shape[0]], dtype="int32",
                           append_batch_size=False) if lengths else None)
    y = pt.layers.batch_norm(x, data_layout=layout, lengths=lens)
    g = pt.layers.data(name="g", shape=list(shape), dtype="float32",
                       append_batch_size=False)
    grads = pt.append_backward(pt.layers.reduce_sum(
        pt.layers.elementwise_mul(y, g)))
    return (pt.default_main_program(), pt.default_startup_program(),
            [y.name, "x@GRAD"] + [gv.name for _, gv in grads])


def _bn_run(dev, shape, layout, feed, lengths=False):
    """One training BN step of ``build_bn_program`` on the card, the
    counters zeroed just before and read just after: (fetches as card
    tensors, launches, median ms of 5 more steps, each fetching dScale
    and dBias alone)."""
    import paddle_tpu_torch as pt

    main_prog, startup, fetch = build_bn_program(pt, shape, layout, lengths)
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    zero_counters()
    out = exe.run(main_prog, feed=feed, fetch_list=fetch, scope=scope,
                  return_numpy=False)
    launches = counters()
    ms = time_ms(lambda: exe.run(main_prog, feed=feed, fetch_list=fetch[2:],
                                 scope=scope), reps=5, warmup=1)
    return out, launches, ms


def phase_bn_layouts(dev, smi, lens):
    """15m (C): training BN, forward and backward, on NHWC input at
    NHWC_BN_SHAPE against the NCHW op on the same values permuted: Y, dX,
    dScale and dBias equal bit for bit (one BN forward and one backward
    launch each, on the same (R, C) rows); and on sequence frames
    SEQ_BN_SHAPE with ``lens`` (phase A's) against the plain masked
    version on the same card tensors (statistics over the real frames, Y
    and dX zero past each length) within BN_TOL and BN_VEC_TOL, one BN
    forward and one backward launch."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(15)
    shape = NHWC_BN_SHAPE
    x = torch.randn(shape, device=dev, generator=gen) * 2 + 0.5
    g = torch.randn(shape, device=dev, generator=gen)
    want = dict.fromkeys(KERNELS, 0)
    want.update(batch_norm_fwd=1, batch_norm_bwd=1)
    out, launches, ms = {}, {}, {}
    for layout, perm in (("NHWC", (0, 1, 2, 3)), ("NCHW", (0, 3, 1, 2))):
        res, launches[layout], ms[layout] = _bn_run(
            dev, tuple(shape[i] for i in perm), layout,
            {"x": x.permute(perm), "g": g.permute(perm)})
        if launches[layout] != want:
            fail(f"{layout} BN at {shape}: launches {launches[layout]}")
        inv = tuple(int(i) for i in np.argsort(perm))
        out[layout] = [res[0].permute(inv), res[1].permute(inv)] + res[2:]
    for name, a, b in zip(("Y", "dX", "dScale", "dBias"), out["NHWC"],
                          out["NCHW"]):
        if not torch.equal(a, b):
            fail(f"NHWC BN at {shape}: {name} differs from the NCHW op on "
                 f"the permuted input (max abs "
                 f"{float((a - b).abs().max()):.3e})")
    log(f"NHWC BN at {shape}: Y, dX, dScale, dBias equal the NCHW op's on "
        f"the permuted input bit for bit; launches 1 forward / 1 backward "
        f"each; a forward and backward step {ms['NHWC']:.3f} ms NHWC, "
        f"{ms['NCHW']:.3f} ms NCHW on {smi}")
    b, t, c = SEQ_BN_SHAPE
    xs = torch.randn(SEQ_BN_SHAPE, device=dev, generator=gen) * 2 + 0.5
    gs = torch.randn(SEQ_BN_SHAPE, device=dev, generator=gen)
    lt = torch.as_tensor(np.asarray(lens, np.int32), device=dev)
    (y, dx, dscale, dbias), seq_launches, seq_ms = _bn_run(
        dev, SEQ_BN_SHAPE, "NCHW", {"x": xs, "g": gs, "len": lt},
        lengths=True)
    if seq_launches != want:
        fail(f"sequence BN at {SEQ_BN_SHAPE}: launches {seq_launches}")
    xt = xs.clone().requires_grad_(True)
    valid = (torch.arange(t, device=dev)[None, :]
             < lt.long()[:, None])[:, :, None].float()
    n = valid.sum()
    mean = (xt * valid).sum((0, 1)) / n
    var = ((xt * valid) ** 2).sum((0, 1)) / n - mean ** 2
    xhat = (xt - mean) * torch.rsqrt(var + BN_EPS)
    yp = xhat * valid
    (dxp,) = torch.autograd.grad((yp * gs).sum(), xt)
    gv = gs * valid
    errs = {}
    for name, got_, plain in (("Y", y, yp.detach()), ("dX", dx, dxp)):
        errs[name] = check_close(f"sequence BN {name}", got_, plain,
                                 **BN_TOL)
    for name, got_, plain in (("dBias", dbias, gv.sum((0, 1))),
                              ("dScale", dscale,
                               (gv * xhat.detach()).sum((0, 1)))):
        errs[name] = check_scaled(f"sequence BN {name}", got_, plain,
                                  BN_VEC_TOL)
    rows = int(n)
    log(f"sequence BN at {SEQ_BN_SHAPE} ({rows} real frames of {b * t}): "
        f"against the plain masked version max abs err {errs}; launches 1 "
        f"forward / 1 backward; a forward and backward step {seq_ms:.3f} ms"
        f" on {smi}")
    return dict(nhwc=launches["NHWC"], nchw=launches["NCHW"],
                sequence=seq_launches)


def _beam_programs(pt, b=BEAM_B, k=BEAM_K, v=BEAM_V, t=BEAM_STEPS):
    """The beam_search op over (b, k) beams and (b, k, v) scores, and the
    beam_search_decode op over (t, b, k) stacks, as two Programs:
    (step, its fetches, decode, its fetches)."""
    from paddle_tpu_torch.layer_helper import LayerHelper

    step, decode = pt.Program(), pt.Program()
    with pt.program_guard(step, pt.Program()):
        ins = {"pre_ids": [pt.layers.data(name="pi", shape=[b, k],
                                          dtype="int64",
                                          append_batch_size=False)],
               "pre_scores": [pt.layers.data(name="ps", shape=[b, k],
                                             append_batch_size=False)],
               "scores": [pt.layers.data(name="s", shape=[b, k, v],
                                         append_batch_size=False)]}
        helper = LayerHelper("beam")
        outs = [helper.create_tmp_variable(dt, (b, k))
                for dt in ("int64", "float32", "int64")]
        helper.append_op(type="beam_search", inputs=ins,
                         outputs={"selected_ids": [outs[0]],
                                  "selected_scores": [outs[1]],
                                  "parent_idx": [outs[2]]},
                         attrs={"beam_size": k, "end_id": 0})
    with pt.program_guard(decode, pt.Program()):
        ids, par, sc = (pt.layers.data(name=n, shape=[t, b, k], dtype=dt,
                                       append_batch_size=False)
                        for n, dt in (("ids", "int64"), ("par", "int64"),
                                      ("sc", "float32")))
        sent = pt.layers.beam_search_decode(ids, sc, parent_idx=par)
    return step, outs, decode, list(sent)


def _near_tie_rows(total, k, tol):
    """Rows (B,) of (B, K, V) candidate totals whose sorted top K + 1 come
    within ``tol`` of each other: where two devices may pick in other
    orders."""
    top = total.reshape(total.shape[0], -1).topk(k + 1, dim=1).values
    return (top[:, :-1] - top[:, 1:]).min(1).values < tol


def _markov_step(table, v, beams=True):
    """A seeded Markov step over vocab ``v``: the scores of the next token
    depend on the current one alone, read from ``table`` at a hashed
    index (integer arithmetic, the same on both devices); with ``beams``
    a count carried in the state (gathered along the beams)."""
    import torch

    cols = torch.arange(v, device=table.device) * 104729

    def step(tokens, state):
        idx = (tokens.long()[..., None] * 7919 + cols) % table.shape[0]
        logits = table[idx]
        if not beams:
            return logits, state
        return logits, {"count": state["count"] + 1}

    return step


def phase_beams(dev, smi):
    """15n (D): the beam_search op over BEAM_STEPS steps of seeded scores
    (token 0, the end id, raised so that beams finish) at B 16, K 4,
    V 30000, each device's beams fed back step by step, then the
    beam_search_decode op over the stacks; and ``decoding.beam_search``
    and ``greedy_search`` over a seeded Markov step function
    (``_markov_step``).  Card and CPU agree token for token, except rows
    where the CPU's candidates come within BEAM_SCORE_TOL of each other
    around the K-th place (counted; at most a quarter of the rows);
    scores within BEAM_SCORE_TOL of max(1, max|CPU|).  ms a beam step
    (median) and a decode."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import decoding
    from paddle_tpu_torch.ops.beam_ops import NEG_INF, extend_scores

    b, k, v, t = BEAM_B, BEAM_K, BEAM_V, BEAM_STEPS
    step, outs, decode, sent = _beam_programs(pt)
    gen = torch.Generator(device=dev).manual_seed(16)
    scores = [torch.randn(b, k, v, device=dev, generator=gen) * 3
              for _ in range(t)]
    for s in scores:
        s[..., 0] += 6.0
    stacks, near, step_ms = {}, torch.zeros(b, dtype=torch.bool), []
    zero_counters()
    for name, place in (("cpu", pt.CPUPlace()), ("card", pt.CUDAPlace(0))):
        exe = pt.Executor(place)
        d = place.device()
        pi = torch.ones(b, k, dtype=torch.int64, device=d)
        ps = torch.tensor([0.0] + [NEG_INF] * (k - 1),
                          device=d).expand(b, k).contiguous()
        stack = []
        for i in range(t):
            s = scores[i].to(d)
            if name == "cpu":
                near |= _near_tie_rows(extend_scores(ps, s, pi == 0, 0), k,
                                       BEAM_SCORE_TOL)
            t0 = time.perf_counter()
            pi, ps, par = exe.run(step, feed={"pi": pi, "ps": ps, "s": s},
                                  fetch_list=outs, return_numpy=False)
            if name == "card":
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            stack.append((pi, par, ps))
        feed = {n: torch.stack([st[j] for st in stack])
                for j, n in enumerate(("ids", "par", "sc"))}
        stacks[name] = [o.cpu() for o in exe.run(
            decode, feed=feed, fetch_list=sent, return_numpy=False)]
    launches = counters()
    if any(launches.values()):
        fail(f"beams: the beam ops launched kernels: {launches}")
    keep = ~near
    if int(near.sum()) > b // 4:
        fail(f"beams: {int(near.sum())} of {b} rows near-tied")
    (ids_c, sc_c), (ids_g, sc_g) = stacks["cpu"], stacks["card"]
    if not torch.equal(ids_c[keep], ids_g[keep]):
        fail("beams: the decoded sentences differ between card and CPU")
    tol = BEAM_SCORE_TOL * max(1.0, float(sc_c.abs().max()))
    if float((sc_c - sc_g).abs().max()) > tol:
        fail(f"beams: final scores differ by "
             f"{float((sc_c - sc_g).abs().max()):.3e} > {tol:.3e}")
    finished = int((ids_c[:, :, -1] == 0).sum())
    log(f"beam_search op x{t} + beam_search_decode at B {b} K {k} V {v}: "
        f"card = CPU token for token on {int(keep.sum())} of {b} rows "
        f"({int(near.sum())} near-tied), {finished} of {b * k} beams ended;"
        f" a step {statistics.median(step_ms):.3f} ms (median, the "
        f"Executor.run and its sync) on {smi}")
    table = torch.randn(100003, generator=torch.Generator().manual_seed(17)
                        ) * 2
    res = {}
    for name, place in (("cpu", pt.CPUPlace()), ("card", None)):
        d = dev if place is None else place.device()
        tab = table.to(d)
        t0 = time.perf_counter()
        seqs, sc = decoding.beam_search(
            _markov_step(tab, v), {"count": torch.zeros(b, k, 1, device=d)},
            b, k, v, bos_id=1, eos_id=0, max_len=t, place=place)
        greedy = decoding.greedy_search(_markov_step(tab, v, beams=False),
                                        None, b, bos_id=1, eos_id=0,
                                        max_len=t, place=place)
        if name == "card":
            torch.cuda.synchronize()
        res[name] = (seqs.cpu(), sc.cpu(), greedy.cpu(),
                       (time.perf_counter() - t0) * 1e3)
    (s_c, sc_c, g_c, cpu_ms), (s_g, sc_g, g_g, card_ms) = (res["cpu"],
                                                           res["card"])
    if not (torch.equal(s_c, s_g) and torch.equal(g_c, g_g)):
        fail("decoding: beam or greedy ids differ between card and CPU")
    tol = BEAM_SCORE_TOL * max(1.0, float(sc_c.abs().max()))
    if float((sc_c - sc_g).abs().max()) > tol:
        fail(f"decoding: beam scores differ by "
             f"{float((sc_c - sc_g).abs().max()):.3e} > {tol:.3e}")
    log(f"decoding.beam_search and greedy_search over a Markov step, B {b} "
        f"K {k} V {v} {t} steps: card = CPU token for token; "
        f"{card_ms:.1f} ms on the card, {cpu_ms:.1f} ms on the CPU, both "
        f"decodes, on {smi}")
    return dict(launches=launches)


# ---------------------------------------------------------------------------
# the fluid op tail: the semantic-role tagger, the text conv net, the ops
# ---------------------------------------------------------------------------


def build_srl(fl, depth=8, word_dict=44068, pred_dict=3162, mark_dict=2,
              word_dim=32, mark_dim=5, hidden=512, labels=67, lr=SRL_LR,
              seed=2026):
    """Phase 15o's program, the fluid book's db_lstm with the layers of
    package ``fl``: six word features (padded (B, T, 1) int64) through one
    shared table ``emb``, the predicate through ``vemb``, the mark through
    its own; an fc(``hidden``) of each, summed; an lstm of hidden / 4 with
    the rows' lengths; then ``depth - 1`` layers of sums(fc(mix),
    fc(lstm)) -> lstm, reversed at odd layers; the emission sums(fc(mix,
    labels), fc(lstm, labels)); linear_chain_crf over the transition
    ``crfw`` and its mean the cost, Adam(lr); crf_decoding on ``crfw``.
    The LSTMs keep the default activations (the kernel's).  Returns (main,
    startup, cost, decode)."""
    fl.framework.reset_default_programs()
    main_prog = fl.default_main_program()
    startup = fl.default_startup_program()
    main_prog.seed = startup.seed = seed
    L = fl.layers

    def ids(name):
        return L.data(name=name, shape=[-1, 1], dtype="int64")

    embs = [L.embedding(input=ids(n), size=[word_dict, word_dim],
                        param_attr=fl.ParamAttr(name="emb"))
            for n in SRL_WORDS]
    embs.append(L.embedding(input=ids("verb"), size=[pred_dict, word_dim],
                            param_attr=fl.ParamAttr(name="vemb")))
    embs.append(L.embedding(input=ids("mark"), size=[mark_dict, mark_dim]))
    target = L.data(name="target", shape=[-1], dtype="int64")
    length = L.data(name="length", shape=[1], dtype="int64")
    mix = L.sums([L.fc(input=e, size=hidden, num_flatten_dims=2)
                  for e in embs])
    lstm, _ = L.lstm(input=mix, size=hidden // 4, lengths=length)
    for i in range(1, depth):
        mix = L.sums([L.fc(input=mix, size=hidden, num_flatten_dims=2),
                      L.fc(input=lstm, size=hidden, num_flatten_dims=2)])
        lstm, _ = L.lstm(input=mix, size=hidden // 4, is_reverse=i % 2 == 1,
                         lengths=length)
    emission = L.sums([L.fc(input=mix, size=labels, num_flatten_dims=2),
                       L.fc(input=lstm, size=labels, num_flatten_dims=2)])
    crf = L.linear_chain_crf(emission, target, length=length,
                             param_attr=fl.ParamAttr(name="crfw"))
    cost = L.mean(crf)
    decode = L.crf_decoding(emission, param_attr=fl.ParamAttr(name="crfw"),
                            length=length)
    fl.optimizer.Adam(learning_rate=lr).minimize(cost)
    return main_prog, startup, cost, decode


def srl_feed(rng, batch, lens=SRL_LENS, word_dict=44068, pred_dict=3162,
             labels=67, words=600):
    """A batch of the tagging rule as numpy: lengths seeded in
    [lens[0], lens[1]], words from a seeded subset of ``words`` ids of the
    table, each word's context the neighbours (0 past the edges), one
    predicate a sentence marked over its 5-word window.  A word tags O
    (the last label) or, for a third of the subset, begins (B) a chunk of
    the word's type, continued (I) while the next words share it: a rule
    of the words that the tables and the CRF can learn, in IOB with
    (labels - 1) / 2 types.  Padding ids 0, tags O."""
    n_types = (labels - 1) // 2
    vocab = rng.choice(word_dict, words, replace=False)
    kind = rng.randint(0, 3 * n_types, words)      # < n_types: a chunk type
    ln = rng.randint(lens[0], lens[1] + 1, batch)
    T = int(ln.max())
    pick = rng.randint(0, words, (batch, T))
    w = np.where(np.arange(T)[None] < ln[:, None], vocab[pick], 0)
    k = np.where(np.arange(T)[None] < ln[:, None], kind[pick], 3 * n_types)
    tags = np.full((batch, T), labels - 1, np.int64)
    for b in range(batch):
        for t in range(ln[b]):
            if k[b, t] < n_types:
                same = t > 0 and k[b, t - 1] == k[b, t]
                tags[b, t] = 2 * k[b, t] + same
    feed = {}
    for off, name in zip(range(-2, 3), SRL_WORDS[1:]):
        c = np.zeros_like(w)
        src = np.arange(T) + off
        ok = (src >= 0) & (src < T)
        c[:, ok] = w[:, src[ok]]
        feed[name] = c[..., None].astype(np.int64)
    feed["word"] = w[..., None].astype(np.int64)
    at = rng.randint(0, ln)
    feed["verb"] = np.repeat(rng.randint(0, pred_dict, (batch, 1)), T,
                             1)[..., None].astype(np.int64)
    feed["mark"] = (np.abs(np.arange(T)[None] - at[:, None]) <= 2)[
        ..., None].astype(np.int64)
    feed["target"] = tags
    feed["length"] = ln.reshape(-1, 1).astype(np.int64)
    return feed


def build_chunk_eval(fl, labels=67):
    """chunk_eval of decoded paths against targets, both fed as LoD rows
    (each sentence's valid steps, so padding stays out of the counts),
    IOB over (labels - 1) / 2 types.  Returns (main, outputs)."""
    fl.framework.reset_default_programs()
    L = fl.layers
    inf = L.data(name="inference", shape=[1], dtype="int64", lod_level=1)
    lab = L.data(name="label", shape=[1], dtype="int64", lod_level=1)
    outs = L.chunk_eval(inf, lab, "IOB", num_chunk_types=(labels - 1) // 2)
    return fl.default_main_program(), list(outs)


def chunk_feed(paths, feed):
    """{inference, label} as LoD rows of each sentence's valid steps."""
    ln = feed["length"].reshape(-1)
    off = np.concatenate([[0], np.cumsum(ln)]).tolist()
    rows = [np.asarray(paths)[b, :n] for b, n in enumerate(ln)]
    tags = [feed["target"][b, :n] for b, n in enumerate(ln)]
    return {"inference": (np.concatenate(rows).reshape(-1, 1)
                          .astype(np.int64), [off]),
            "label": (np.concatenate(tags).reshape(-1, 1).astype(np.int64),
                      [off])}


def viterbi_margins(emission, transition, lengths):
    """Each row's smallest Viterbi margin on its best path, on the host in
    float64: at the final choice and at each back-pointer the path
    follows, the best score less the runner-up.  A path whose margin is
    tiny may decode otherwise under another rounding."""
    em = np.asarray(emission, np.float64)
    tr = np.asarray(transition, np.float64)
    start, end, pair = tr[0], tr[1], tr[2:]
    out = []
    for b in range(em.shape[0]):
        n = int(lengths[b])
        delta = start + em[b, 0]
        steps = []
        for t in range(1, n):
            s = delta[:, None] + pair
            steps.append(s)
            delta = s.max(0) + em[b, t]
        fin = delta + end
        top = np.sort(fin)
        margin = float(top[-1] - top[-2]) if top.size > 1 else np.inf
        j = int(np.argmax(fin))
        for s in reversed(steps):
            col = np.sort(s[:, j])
            margin = min(margin, float(col[-1] - col[-2]))
            j = int(np.argmax(s[:, j]))
        out.append(margin)
    return np.asarray(out)

def build_ssd_head(fl, maps=SSD_MAPS, image=300, b=SSD_B,
                   classes=SSD_CLASSES, gt=SSD_GT, mins=SSD_MIN, maxs=SSD_MAX,
                   ratios=SSD_RATIOS, nms_top_k=400, keep_top_k=200,
                   nms=True):
    """Phase 15q's SSD head with the layers of package ``fl``: a
    prior_box over each feature map (s x s, SSD300's min and max size and
    aspect ratios, flipped, clipped) against a (b, 3, image, image) image,
    concatenated to (M, 4) priors; fed loc (b, M, 4) and conf (b, M,
    classes) with gradients, ground truth (b, gt, 4) and labels (b, gt)
    (-1 padding); box_coder decodes loc and encodes it back, ssd_loss
    (its mean differentiated), and with ``nms`` multiclass_nms over the
    decoded boxes and the softmax scores.  Returns (main, [priors,
    variances, decoded, encoded, loss(, detections)], M)."""
    fl.framework.reset_default_programs()
    L = fl.layers

    def feed(name, shape, dtype="float32", grad=False):
        v = L.data(name=name, shape=list(shape), dtype=dtype,
                   append_batch_size=False)
        v.stop_gradient = not grad
        return v

    img = feed("image", (b, 3, image, image))
    boxes, variances = [], []
    for i, ((s, _), mn, mx, ar) in enumerate(zip(maps, mins, maxs, ratios)):
        bx, vr = L.prior_box(feed(f"map{i}", (b, 1, s, s)), img,
                             min_sizes=[float(mn)], max_sizes=[float(mx)],
                             aspect_ratios=[float(r) for r in ar])
        boxes.append(L.reshape(bx, [-1, 4]))
        variances.append(L.reshape(vr, [-1, 4]))
    prior, pvar = L.concat(boxes, axis=0), L.concat(variances, axis=0)
    M = sum(s * s * p for s, p in maps)
    loc = feed("loc", (b, M, 4), grad=True)
    conf = feed("conf", (b, M, classes), grad=True)
    dec = L.box_coder(prior, pvar, loc, code_type="decode_center_size")
    enc = L.box_coder(prior, pvar, dec, code_type="encode_center_size")
    loss = L.ssd_loss(loc, conf, prior, pvar, feed("gt_box", (b, gt, 4)),
                      feed("gt_label", (b, gt), "int64"))
    fl.append_backward(L.mean(loss))
    outs = [prior, pvar, dec, enc, loss]
    if nms:
        scores = L.transpose(L.softmax(conf), [0, 2, 1])
        outs.append(L.detection_output(
            dec, scores, score_threshold=0.01, nms_threshold=0.45,
            nms_top_k=nms_top_k, keep_top_k=keep_top_k))
    return fl.default_main_program(), outs, M


def ssd_feed(rng, maps=SSD_MAPS, image=300, b=SSD_B, classes=SSD_CLASSES,
             gt=SSD_GT):
    """The SSD head's inputs as numpy: zero maps and image (only their
    shapes matter), loc ~ 0.3 N(0, 1), conf ~ N(0, 1) with its class 1
    raised on a third of the priors, 1-``gt`` ground-truth boxes an
    image of sides 0.1-0.6 (-1 labels pad the rest)."""
    M = sum(s * s * p for s, p in maps)
    feed = {f"map{i}": np.zeros((b, 1, s, s), np.float32)
            for i, (s, _) in enumerate(maps)}
    feed["image"] = np.zeros((b, 3, image, image), np.float32)
    feed["loc"] = (0.3 * rng.randn(b, M, 4)).astype(np.float32)
    conf = rng.randn(b, M, classes).astype(np.float32)
    conf[:, ::3, 1] += 3.0
    feed["conf"] = conf
    lo = rng.rand(b, gt, 2) * 0.4
    side = 0.1 + rng.rand(b, gt, 2) * 0.5
    feed["gt_box"] = np.concatenate([lo, np.minimum(lo + side, 1.0)],
                                    -1).astype(np.float32)
    labels = rng.randint(1, classes, (b, gt))
    n = rng.randint(1, gt + 1, b)
    labels[np.arange(gt)[None] >= n[:, None]] = -1
    feed["gt_label"] = labels.astype(np.int64)
    return feed


def build_text_conv(fl, vocab=LSTM_VOCAB, emb=LSTM_EMB,
                    filters=TEXT_FILTERS, lr=TEXT_LR, seed=2026):
    """Phase 15p's program, understand_sentiment's convolution_net with
    the layers and nets of package ``fl`` over LoD ids: embedding, two
    sequence_conv_pools (filter sizes 3 and 4, tanh, sqrt pooling), fc(2,
    softmax) over both, cross_entropy, mean, Adam(lr).  Returns (main,
    startup, loss)."""
    fl.framework.reset_default_programs()
    main_prog = fl.default_main_program()
    startup = fl.default_startup_program()
    main_prog.seed = startup.seed = seed
    L = fl.layers
    ids = L.data(name="ids", shape=[1], dtype="int64", lod_level=1)
    label = L.data(name="label", shape=[1], dtype="int64")
    x = L.embedding(input=ids, size=[vocab, emb])
    convs = [fl.nets.sequence_conv_pool(input=x, num_filters=filters,
                                        filter_size=k, act="tanh",
                                        pool_type="sqrt") for k in (3, 4)]
    pred = L.fc(input=convs, size=2, act="softmax")
    loss = L.mean(L.cross_entropy(input=pred, label=label))
    fl.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main_prog, startup, loss


def _two_costs(exe, main_prog, feeds, fetch, scope):
    return [exe.run(main_prog, feed=f, fetch_list=fetch, scope=scope)
            for f in feeds]


def _check_costs(what, got, want, tol):
    for i, (g, w) in enumerate(zip(got, want)):
        if not (np.isfinite(g) and abs(g - w) <= tol * abs(w)):
            fail(f"{what}: step {i} cost {g:.7f} on the card, {w:.7f} on the "
                 f"CPU (gate {tol} of it)")


def _train(exe, main_prog, feeds, loss, scope, steps, what, expect):
    """``steps`` steps over ``feeds`` in turn, the counters zeroed just
    before the first and read just after (they must equal ``expect``):
    (costs, launches, wgmma launches, ms a step (median of steps 3 on),
    peak bytes)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    costs = [float(exe.run(main_prog, feed=feeds[0], fetch_list=[loss],
                           scope=scope)[0])]
    launches, wgmma = counters(), wgmma_counters()
    log(f"{what}: launches {launches}; on the wgmma engine {wgmma}")
    if launches != expect:
        fail(f"{what}: launch counts {launches} != {expect}")
    times = []
    for i in range(1, steps):
        t0 = time.perf_counter()
        (c,) = exe.run(main_prog, feed=feeds[i % len(feeds)],
                       fetch_list=[loss], scope=scope)
        times.append((time.perf_counter() - t0) * 1e3)
        costs.append(float(c))
    if not np.isfinite(costs).all():
        fail(f"{what}: non-finite costs {costs}")
    return (costs, launches, wgmma, statistics.median(times[2:]),
            torch.cuda.max_memory_allocated())


def phase_srl(dev, smi):
    """15o: the semantic-role tagger (``build_srl``) at SRL_CONFIG's widths.
    Parity at B SRL_PARITY_BATCH from the port's CPU startup copied to the
    card: the first two costs within SRL_COST_TOL (relative) of the CPU
    path's; the decoded paths of step 1 equal but where the CPU's Viterbi
    margin is below SRL_TIE (counted); chunk_eval of those paths on the
    card and on the CPU equal exactly.  Then SRL_STEPS Adam steps at B
    SRL_BATCH over 4 seeded batches in turn from the card's own startup:
    the counters of the first step (lstm 8, lstm_bwd 8, matmul as the
    program implies, nothing else), the mean of the last 3 costs a token
    at most half the first's, ms a step, sentences/s, peak memory."""
    import paddle_tpu_torch as pt

    main_prog, startup, cost, decode = build_srl(pt, **SRL_CONFIG)
    block = main_prog.global_block()
    emission = next(op for op in block.ops if op.type == "crf_decoding") \
        .input("Emission")[0]
    rng = np.random.RandomState(31)
    feeds = [srl_feed(rng, SRL_PARITY_BATCH) for _ in range(2)]
    cpu, card = _cpu_and_card_scopes(startup, dev)
    crfw = cpu.values["crfw"].numpy().copy()
    fetch = [cost, decode, emission]
    want = _two_costs(pt.Executor(pt.CPUPlace()), main_prog, feeds, fetch,
                      cpu)
    exe = pt.Executor()
    got = _two_costs(exe, main_prog, [_card_feed(f, dev) for f in feeds],
                     fetch, card)
    what = f"SRL tagger parity at B {SRL_PARITY_BATCH}"
    _check_costs(what, [float(g[0]) for g in got], [float(w[0]) for w in want],
                 SRL_COST_TOL)
    margins = viterbi_margins(want[0][2], crfw, feeds[0]["length"].reshape(-1))
    near = margins < SRL_TIE
    paths, cpu_paths = np.asarray(got[0][1]), np.asarray(want[0][1])
    differ = (paths != cpu_paths).any(1)
    if (differ & ~near).any():
        fail(f"{what}: rows {np.flatnonzero(differ & ~near).tolist()} decode "
             f"differently on the card (margins {margins.tolist()})")
    chunk_prog, chunk_outs = build_chunk_eval(pt)
    cfeed = chunk_feed(paths, feeds[0])
    on_card = pt.Executor().run(chunk_prog, feed=_card_feed(cfeed, dev),
                                fetch_list=chunk_outs, scope=pt.Scope())
    on_cpu = pt.Executor(pt.CPUPlace()).run(chunk_prog, feed=cfeed,
                                             fetch_list=chunk_outs,
                                             scope=pt.Scope())
    counts = [int(np.asarray(v).reshape(-1)[0]) for v in on_card[3:]]
    if counts != [int(np.asarray(v).reshape(-1)[0]) for v in on_cpu[3:]]:
        fail(f"{what}: chunk counts {counts} on the card, "
             f"{[np.asarray(v).tolist() for v in on_cpu[3:]]} on the CPU")
    log(f"{what}: costs {[float(g[0]) for g in got]} on the card, "
        f"{[float(w[0]) for w in want]} on the CPU (gate {SRL_COST_TOL}); "
        f"paths: {int(differ.sum())} rows differ, {int(near.sum())} rows at a "
        f"Viterbi near-tie (margin < {SRL_TIE}; smallest margin "
        f"{margins.min():.3e}); chunk_eval inferred/labelled/correct "
        f"{counts}, precision {float(on_card[0][0]):.4f}, F1 "
        f"{float(on_card[2][0]):.4f}, equal on both")
    del card, cpu

    expect = launches_implied(main_prog)
    if (expect["lstm"], expect["lstm_bwd"]) != (8, 8):
        fail(f"SRL tagger: the program implies {expect}, not 8 + 8 LSTM "
             "launches")
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    batches = [_card_feed(srl_feed(rng, SRL_BATCH), dev) for _ in range(4)]
    rows = [int(b["length"].sum()) for b in batches]
    what = (f"SRL tagger step, B {SRL_BATCH}, {rows[0]} tokens padded to "
            f"{int(batches[0]['word'].shape[1])}")
    costs, launches, wgmma, ms, peak = _train(
        exe, main_prog, batches, cost, scope, SRL_STEPS, what, expect)
    # the cost is a sentence's: per token, batches of other lengths compare
    per_token = [c * SRL_BATCH / rows[i % 4] for i, c in enumerate(costs)]
    if not np.mean(per_token[-3:]) <= 0.5 * per_token[0]:
        fail(f"{what}: the cost a token does not halve in {SRL_STEPS} "
             f"steps: {per_token}")
    log(f"{what}: costs a token {[round(c, 4) for c in per_token]}; "
        f"{ms:.3f} ms a step "
        f"(median of steps 3-{SRL_STEPS - 1}), {SRL_BATCH / ms * 1e3:.1f} "
        f"sentences/s, {np.mean(rows) / ms * 1e3:.1f} tokens/s; matmul "
        f"launches a step {launches['matmul']}, {wgmma['matmul']} on the "
        f"wgmma engine; peak memory allocated {peak / 2**30:.3f} GiB on {smi}")
    del exe, scope
    return dict(launches=launches, wgmma=wgmma, ms_per_step=ms,
                sentences_per_s=SRL_BATCH / ms * 1e3, peak_bytes=peak,
                costs=costs)


def text_conv_feed(rng, n_seq=LOD_SEQS):
    feed = attention_feed(rng, n_seq=n_seq)
    del feed["aux"]
    return feed


def phase_text_conv(dev, smi):
    """15p: understand_sentiment's convolution_net (``build_text_conv``)
    over LoD ids at the LoD cell's widths.  Parity at 4 sequences as
    15o's; then TEXT_STEPS Adam steps over 4 seeded batches of LOD_SEQS
    sequences (a label the ids decide, ``attention_feed``): the counters
    of the first step (the gather 1; matmul 6: each sequence_conv's
    product and its replay under the gradient, the head's two muls;
    softmax 1), the mean of the last 3 costs under the first 3's, ms a
    step, samples/s, peak memory."""
    import paddle_tpu_torch as pt

    main_prog, startup, loss = build_text_conv(pt)
    rng = np.random.RandomState(32)
    feeds = [text_conv_feed(rng, 4) for _ in range(2)]
    cpu, card = _cpu_and_card_scopes(startup, dev)
    want = _two_costs(pt.Executor(pt.CPUPlace()), main_prog, feeds, [loss],
                      cpu)
    exe = pt.Executor()
    got = _two_costs(exe, main_prog, [_card_feed(f, dev) for f in feeds],
                     [loss], card)
    what = "text conv parity at 4 sequences"
    _check_costs(what, [float(g[0]) for g in got], [float(w[0]) for w in want],
                 SRL_COST_TOL)
    log(f"{what}: costs {[float(g[0]) for g in got]} on the card, "
        f"{[float(w[0]) for w in want]} on the CPU (gate {SRL_COST_TOL})")
    del card, cpu
    expect = dict.fromkeys(KERNELS, 0)
    expect.update(embedding=1, matmul=6, softmax=1)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    batches = [_card_feed(text_conv_feed(rng), dev) for _ in range(4)]
    rows = int(batches[0]["ids"].data.shape[0])
    what = f"text conv step, {LOD_SEQS} sequences of {rows} rows"
    costs, launches, wgmma, ms, peak = _train(
        exe, main_prog, batches, loss, scope, TEXT_STEPS, what, expect)
    if not np.mean(costs[-3:]) < np.mean(costs[:3]):
        fail(f"{what}: the costs do not fall: {costs}")
    log(f"{what}: costs {[round(c, 4) for c in costs]}; {ms:.3f} ms a step "
        f"(median of steps 3-{TEXT_STEPS - 1}), {LOD_SEQS / ms * 1e3:.1f} "
        f"samples/s; peak memory allocated {peak / 2**30:.3f} GiB on {smi}")
    del exe, scope
    return dict(launches=launches, wgmma=wgmma, ms_per_step=ms,
                samples_per_s=LOD_SEQS / ms * 1e3, peak_bytes=peak,
                costs=costs)


def op_program(pt, type_, feeds, inputs, outputs, attrs=None, grads=()):
    """One op of type ``type_`` over fed inputs {slot: name or [names]}
    with outputs {slot: (dtype, shape)}; with ``grads``, mean(out * out)
    of every float output summed and differentiated, the feeds named in
    ``grads`` taking gradients.  Returns (program, fetch names)."""
    pt.framework.reset_default_programs()
    L = pt.layers
    vs = {}
    for n, v in feeds.items():
        arr = v[0] if isinstance(v, tuple) else v
        dt = "int64" if arr.dtype.kind in "iu" else str(arr.dtype)
        vs[n] = (L.data(name=n, shape=list(arr.shape[1:]), dtype=dt,
                        lod_level=1) if isinstance(v, tuple)
                 else L.data(name=n, shape=list(arr.shape), dtype=dt,
                             append_batch_size=False))
        vs[n].stop_gradient = n not in grads
    helper = pt.layer_helper.LayerHelper(type_)
    outs = {slot: helper.create_tmp_variable(dt, shape)
            for slot, (dt, shape) in outputs.items()}
    helper.append_op(
        type=type_, outputs={k: [v] for k, v in outs.items()},
        inputs={slot: [vs[n] for n in (names if isinstance(names, list)
                                       else [names])]
                for slot, names in inputs.items()}, attrs=attrs or {})
    fetch = [v.name for v in outs.values()]
    if grads:
        terms = [L.mean(L.elementwise_mul(o, o)) for o in outs.values()
                 if o.dtype.startswith("float")]
        pt.append_backward(terms[0] if len(terms) == 1 else L.sums(terms))
        fetch += [n + "@GRAD" for n in grads]
    return pt.default_main_program(), fetch


def op_tail_cases(rng):
    """(type, feeds, inputs, outputs, attrs, grads) of phase 15q: every op
    of the tail at a small shape, and the real-size cases
    (warpctc at B 32 T 100 C 96, hsigmoid over 10,000 classes at D 256,
    conv2d_transpose 4 x 4 stride 2 64 -> 32 channels at 32 x 32, conv3d
    and pool3d on (4, 16, 16, 32, 32))."""
    def f(*s, scale=1.0):
        return (rng.randn(*s) * scale).astype(np.float32)

    def i(lo, hi, *s):
        return rng.randint(lo, hi, s).astype(np.int64)

    lens = [3, 1, 4]
    off = np.concatenate([[0], np.cumsum(lens)]).tolist()
    lod = (f(off[-1] + 2, 3), [off])
    B, T, C, S = 32, 100, 96, 30
    ll = i(1, S + 1, B)
    lb = np.zeros((B, S), np.int64)
    for b in range(B):
        lb[b, :ll[b]] = rng.randint(1, C, ll[b])
    ctc = {"lg": f(B, T, C), "lb": lb, "tl": i(60, T + 1, B, 1),
           "ll": ll.reshape(-1, 1)}
    roi = np.asarray([[0, 0, 0, 5, 5], [1, 2, 1, 7, 6]], np.float32)
    pool3 = dict(pooling_type="max", ksize=[2, 2, 2], strides=[2, 2, 2])
    ties = f(2, 3, 8, 8)
    ties[:, :, :4, :4] = 0.5
    return [
        ("crf_decoding", {"em": f(4, 9, 7), "tr": f(9, 7),
                          "n": i(1, 10, 4, 1)},
         {"Emission": "em", "Transition": "tr", "Length": "n"},
         {"ViterbiPath": ("int64", (4, 9))}, {}, ()),
        # every score tied: the first maximum at each step
        ("crf_decoding", {"em": np.zeros((4, 9, 7), np.float32),
                          "tr": np.zeros((9, 7), np.float32),
                          "n": i(1, 10, 4, 1)},
         {"Emission": "em", "Transition": "tr", "Length": "n"},
         {"ViterbiPath": ("int64", (4, 9))}, {}, ()),
        ("chunk_eval", {"a": i(0, 7, 30, 1), "b": i(0, 7, 30, 1)},
         {"Inference": "a", "Label": "b"},
         {"Precision": ("float32", (1,)), "Recall": ("float32", (1,)),
          "F1-Score": ("float32", (1,)), "NumInferChunks": ("int64", (1,)),
          "NumLabelChunks": ("int64", (1,)),
          "NumCorrectChunks": ("int64", (1,))},
         {"chunk_scheme": "IOB", "num_chunk_types": 3}, ()),
        ("sequence_conv", {"x": lod, "w": f(9, 5)}, {"X": "x", "Filter": "w"},
         {"Out": ("float32", (-1, 5))}, {"contextLength": 3}, ("x", "w")),
        ("sequence_slice", {"x": lod, "o": i(0, 1, 3, 1),
                            "n": np.asarray([[2], [1], [3]], np.int64)},
         {"X": "x", "Offset": "o", "Length": "n"},
         {"Out": ("float32", (-1, 3))}, {}, ("x",)),
        ("row_conv", {"x": f(2, 6, 4), "w": f(3, 4)},
         {"X": "x", "Filter": "w"}, {"Out": ("float32", (2, 6, 4))}, {},
         ("x", "w")),
        ("conv_shift", {"x": f(3, 8), "y": f(3, 3)}, {"X": "x", "Y": "y"},
         {"Out": ("float32", (3, 8))}, {}, ("x", "y")),
        ("block_expand", {"x": f(2, 3, 5, 6)}, {"X": "x"},
         {"Out": ("float32", (2, 9, 12)), "OutLength": ("int32", (2,))},
         {"block_y": 2, "block_x": 2}, ("x",)),
        ("norm", {"x": f(2, 4, 3, 3), "s": f(4)}, {"X": "x", "Scale": "s"},
         {"Out": ("float32", (2, 4, 3, 3))}, {}, ("x", "s")),
        ("precision_recall", {"p": f(9, 1), "i": i(0, 4, 9, 1),
                              "l": i(0, 4, 9, 1)},
         {"MaxProbs": "p", "Indices": "i", "Labels": "l"},
         {"BatchMetrics": ("float32", (6,)), "AccumMetrics": ("float32", (6,)),
          "AccumStatesInfo": ("float32", (4, 3))}, {"class_number": 4}, ()),
        ("max_pool2d_with_index", {"x": f(2, 3, 8, 8)}, {"X": "x"},
         {"Out": ("float32", (2, 3, 4, 4)), "Mask": ("int32", (2, 3, 4, 4))},
         {"ksize": [2, 2], "strides": [2, 2]}, ("x",)),
        # four windows of equal values: the first maximum's index
        ("max_pool2d_with_index", {"x": ties}, {"X": "x"},
         {"Out": ("float32", (2, 3, 4, 4)), "Mask": ("int32", (2, 3, 4, 4))},
         {"ksize": [2, 2], "strides": [2, 2]}, ("x",)),
        ("max_pool3d_with_index", {"x": f(1, 2, 4, 4, 4)}, {"X": "x"},
         {"Out": ("float32", (1, 2, 2, 2, 2)),
          "Mask": ("int32", (1, 2, 2, 2, 2))}, {"ksize": [2, 2, 2]}, ("x",)),
        ("unpool", {"x": f(1, 2, 2, 2), "i": np.asarray(
            [[[[0, 3], [9, 14]], [[5, 2], [11, 8]]]], np.int64)},
         {"X": "x", "Indices": "i"}, {"Out": ("float32", (1, 2, 4, 4))},
         {"ksize": [2, 2]}, ("x",)),
        ("pool3d", {"x": f(4, 16, 16, 32, 32)}, {"X": "x"},
         {"Out": ("float32", (4, 16, 8, 16, 16))}, pool3, ("x",)),
        ("pool3d_cudnn", {"x": f(2, 3, 6, 6, 6)}, {"X": "x"},
         {"Out": ("float32", (2, 3, 3, 3, 3))},
         dict(pooling_type="avg", ksize=[3, 3, 3], strides=[2, 2, 2],
              paddings=[1, 1, 1], exclusive=True), ("x",)),
        ("roi_pool", {"x": f(2, 3, 8, 8), "r": roi}, {"X": "x", "ROIs": "r"},
         {"Out": ("float32", (2, 3, 2, 2)), "Argmax": ("int32", (2, 3, 2, 2))},
         {"pooled_height": 2, "pooled_width": 2}, ("x",)),
        ("scale_sub_region_mask", {"x": f(2, 4, 3, 3), "i": np.asarray(
            [[1, 2, 2, 3, 1, 1], [3, 4, 1, 3, 2, 3]], np.int64)},
         {"X": "x", "Indices": "i"}, {"Out": ("float32", (2, 4, 3, 3))},
         {"value": 2.5}, ("x",)),
        ("auc", {"p": np.abs(f(40, 2)) % 1, "i": i(0, 1, 40, 1),
                 "l": i(0, 2, 40, 1)}, {"Out": "p", "Indices": "i",
                                        "Label": "l"},
         {"AUC": ("float32", (1,))}, {"num_thresholds": 200}, ()),
        ("positive_negative_pair", {"s": np.round(np.abs(f(1500, 1)), 1),
                                    "l": i(0, 3, 1500, 1).astype(np.float32),
                                    "q": i(0, 4, 1500, 1)},
         {"Score": "s", "Label": "l", "QueryID": "q"},
         {"PositivePair": ("float32", (1,)), "NegativePair": ("float32", (1,)),
          "NeutralPair": ("float32", (1,))}, {}, ()),
        ("squared_l2_distance", {"x": f(4, 5), "y": f(1, 5)},
         {"X": "x", "Y": "y"}, {"sub_result": ("float32", (4, 5)),
                                "Out": ("float32", (4, 1))}, {}, ("x", "y")),
        ("cos_sim", {"x": f(4, 5), "y": f(4, 15)}, {"X": "x", "Y": "y"},
         {"Out": ("float32", (4, 3)), "XNorm": ("float32", (4, 1)),
          "YNorm": ("float32", (4, 3))}, {}, ("x", "y")),
        ("minus", {"x": f(3, 4), "y": f(3, 4)}, {"X": "x", "Y": "y"},
         {"Out": ("float32", (3, 4))}, {}, ("x", "y")),
        ("bilinear_tensor_product", {"x": f(4, 3), "y": f(4, 5),
                                     "w": f(2, 3, 5), "b": f(1, 2)},
         {"X": "x", "Y": "y", "Weight": "w", "Bias": "b"},
         {"Out": ("float32", (4, 2))}, {}, ("x", "y", "w", "b")),
        ("expand", {"x": f(2, 3)}, {"X": "x"}, {"Out": ("float32", (4, 9))},
         {"expand_times": [2, 3]}, ("x",)),
        ("gather", {"x": f(5, 3), "i": np.asarray([3, 0, 0, 2], np.int64)},
         {"X": "x", "Index": "i"}, {"Out": ("float32", (4, 3))}, {}, ("x",)),
        ("scatter", {"r": f(5, 3), "i": np.asarray([4, 0, 2], np.int64),
                     "u": f(3, 3)}, {"Ref": "r", "Index": "i", "Updates": "u"},
         {"Out": ("float32", (5, 3))}, {}, ("r", "u")),
        ("shape", {"x": f(4, 5, 6)}, {"Input": "x"}, {"Out": ("int32", (3,))},
         {}, ()),
        ("slice_tensor", {"x": f(4, 5, 6)}, {"X": "x"},
         {"Out": ("float32", (2, 5, 4))},
         {"axes": [0, 2], "starts": [1, -4], "ends": [3, 100]}, ("x",)),
        ("one_hot", {"x": np.asarray([[2], [0], [5], [-1]], np.int64)},
         {"X": "x"}, {"Out": ("float32", (4, 4))}, {"depth": 4}, ()),
        ("reverse", {"x": f(4, 5)}, {"X": "x"}, {"Out": ("float32", (4, 5))},
         {"axis": [0, 1]}, ("x",)),
        ("warpctc", ctc, {"Logits": "lg", "Label": "lb",
                          "LogitsLength": "tl", "LabelLength": "ll"},
         {"Loss": ("float32", (B, 1))}, {"blank": 0}, ("lg",)),
        ("hierarchical_sigmoid", {"x": f(256, 256, scale=0.1),
                                  "w": f(9999, 256, scale=0.1),
                                  "b": f(9999, scale=0.1),
                                  "l": i(0, 10000, 256, 1)},
         {"X": "x", "W": "w", "Bias": "b", "Label": "l"},
         {"Cost": ("float32", (256, 1))}, {}, ("x", "w", "b")),
        ("factorization_machine", {"x": f(64, 32), "w": f(32, 8)},
         {"X": "x", "W": "w"}, {"Out": ("float32", (64, 1))}, {}, ("x", "w")),
        ("conv3d", {"x": f(4, 16, 16, 32, 32), "w": f(16, 16, 3, 3, 3,
                                                     scale=0.1)},
         {"Input": "x", "Filter": "w"},
         {"Output": ("float32", (4, 16, 16, 32, 32))},
         {"paddings": [1, 1, 1]}, ("x", "w")),
        ("conv3d_cudnn", {"x": f(2, 3, 5, 6, 6), "w": f(4, 3, 3, 3, 3)},
         {"Input": "x", "Filter": "w"},
         {"Output": ("float32", (2, 4, 3, 2, 2))},
         {"strides": [1, 2, 2]}, ("x", "w")),
        ("conv2d_transpose", {"x": f(8, 64, 32, 32),
                              "w": f(64, 32, 4, 4, scale=0.1)},
         {"Input": "x", "Filter": "w"},
         {"Output": ("float32", (8, 32, 62, 62))},
         {"strides": [2, 2], "paddings": [1, 1]}, ("x", "w")),
        ("conv2d_transpose_cudnn", {"x": f(2, 3, 5, 5), "w": f(3, 4, 3, 3)},
         {"Input": "x", "Filter": "w"},
         {"Output": ("float32", (2, 4, 9, 9))}, {"strides": [2, 2],
                                                 "paddings": [1, 1]},
         ("x", "w")),
        ("conv3d_transpose", {"x": f(2, 3, 4, 4, 4), "w": f(3, 2, 3, 3, 3)},
         {"Input": "x", "Filter": "w"},
         {"Output": ("float32", (2, 2, 7, 7, 7))},
         {"strides": [2, 2, 2], "paddings": [1, 1, 1]}, ("x", "w")),
        ("conv3d_transpose_cudnn", {"x": f(1, 2, 3, 3, 3),
                                    "w": f(2, 2, 2, 2, 2)},
         {"Input": "x", "Filter": "w"},
         {"Output": ("float32", (1, 2, 2, 2, 2))}, {}, ("x", "w")),
        ("bilinear_interp", {"x": f(2, 3, 6, 5)}, {"X": "x"},
         {"Out": ("float32", (2, 3, 9, 3))}, {"out_h": 9, "out_w": 3},
         ("x",)),
        ("crop", {"x": f(2, 4, 5, 6)}, {"X": "x"},
         {"Out": ("float32", (1, 2, 3, 4))},
         {"shape": [1, 2, 3, 4], "offsets": [1, 1, 0, 2]}, ("x",)),
        ("pad", {"x": f(2, 4)}, {"X": "x"}, {"Out": ("float32", (3, 7))},
         {"paddings": [1, 0, 2, 1], "pad_value": 0.5}, ("x",)),
        ("maxout", {"x": f(2, 4, 5, 6)}, {"X": "x"},
         {"Out": ("float32", (2, 2, 5, 6))}, {"groups": 2}, ("x",)),
        ("l1_norm", {"x": f(3, 4)}, {"X": "x"}, {"Out": ("float32", ())}, {},
         ("x",)),
        ("lambda_cost", {"o": f(3, 6, 1), "y": i(0, 4, 3, 6, 1).astype(
            np.float32), "n": np.asarray([6, 4, 2], np.int64)},
         {"Score": "o", "Label": "y", "Length": "n"},
         {"Out": ("float32", (3, 1))}, {"NDCG_num": 3}, ("o",)),
        ("cross_entropy_over_beam", {
            "s0": f(2, 4), "s1": f(2, 6), "i0": np.asarray(
                [[1, 3], [0, 2]], np.int64), "i1": np.asarray(
                    [[4, 0], [1, -1]], np.int64),
            "g0": np.asarray([[3], [2]], np.int64),
            "g1": np.asarray([[4], [5]], np.int64)},
         {"Scores": ["s0", "s1"], "Ids": ["i0", "i1"], "Golds": ["g0", "g1"]},
         {"Out": ("float32", (2, 1))}, {}, ("s0", "s1")),
    ]


def _compare_tail(what, got, want, tol=OP_TAIL_TOL):
    """A card fetch against the CPU's: ints and LoD offsets exactly,
    floats within ``tol`` of max|CPU|.  Returns the float error."""
    from paddle_tpu_torch.lod import LoDArray

    if isinstance(want, LoDArray):
        for g, w in zip(got.lod, want.lod):
            if not np.array_equal(np.asarray(g), np.asarray(w)):
                fail(f"{what}: LoD offsets differ")
        got, want = got.data, want.data
    g, w = np.asarray(got), np.asarray(want)
    if g.shape != w.shape:
        fail(f"{what}: shape {g.shape} on the card, {w.shape} on the CPU")
    if w.dtype.kind in "biu":
        if not np.array_equal(g, w):
            fail(f"{what}: integer outputs differ")
        return 0.0
    err = float(np.abs(g.astype(np.float64) - w).max()) if w.size else 0.0
    scale = float(np.abs(w).max()) if w.size else 0.0
    if not (np.isfinite(g).all() and err <= tol * max(scale, 1e-30)):
        fail(f"{what}: max abs err {err:.3e} > {tol} * max|CPU| {scale:.3e}")
    return err


def _ssd_on_card(dev):
    """The SSD300 head (``build_ssd_head`` without its NMS) on the card
    against the CPU path; multiclass_nms then on both from the CPU's
    decoded boxes and softmax scores (equal inputs: its IoU compares and
    stable sorts then see the same values)."""
    import paddle_tpu_torch as pt

    main_prog, outs, M = build_ssd_head(pt, nms=False)
    if M != 8732:
        fail(f"SSD300 head: {M} priors, not 8732")
    feed = ssd_feed(np.random.RandomState(33))
    fetch = [o.name for o in outs] + ["loc@GRAD", "conf@GRAD"]
    t0 = time.perf_counter()
    want = pt.Executor(pt.CPUPlace()).run(main_prog, feed=feed,
                                          fetch_list=fetch, scope=pt.Scope())
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = pt.Executor().run(main_prog, feed=_card_feed(feed, dev),
                            fetch_list=fetch, scope=pt.Scope())
    head_s = time.perf_counter() - t0
    errs = {n: _compare_tail(f"SSD300 head {n}", g, w)
            for n, g, w in zip(("priors", "variances", "decoded", "encoded",
                                "loss", "loc@GRAD", "conf@GRAD"), got, want)}
    conf = feed["conf"].astype(np.float64)
    probs = np.exp(conf - conf.max(-1, keepdims=True))
    scores = (probs / probs.sum(-1, keepdims=True)).astype(np.float32) \
        .transpose(0, 2, 1).copy()
    nms_feed = {"bb": np.asarray(want[2]), "sc": scores}
    prog, nfetch = op_program(
        pt, "multiclass_nms", nms_feed, {"BBoxes": "bb", "Scores": "sc"},
        {"Out": ("float32", (SSD_B, 200, 6))},
        {"score_threshold": 0.01, "nms_threshold": 0.45, "nms_top_k": 400,
         "keep_top_k": 200})
    (w_nms,) = pt.Executor(pt.CPUPlace()).run(prog, feed=nms_feed,
                                              fetch_list=nfetch,
                                              scope=pt.Scope())
    t0 = time.perf_counter()
    (g_nms,) = pt.Executor().run(prog, feed=_card_feed(nms_feed, dev),
                                 fetch_list=nfetch, scope=pt.Scope())
    nms_s = time.perf_counter() - t0
    errs["detections"] = _compare_tail("SSD300 multiclass_nms", g_nms, w_nms)
    kept = int((np.asarray(g_nms)[:, :, 0] >= 0).sum())
    log(f"SSD300 head at B {SSD_B}, {M} priors, {SSD_CLASSES} classes: card "
        f"vs CPU max abs err {errs} (tolerance {OP_TAIL_TOL} of max); the "
        f"head with ssd_loss's backward {head_s * 1e3:.1f} ms, "
        f"multiclass_nms (nms_top_k 400, keep_top_k 200) {nms_s * 1e3:.1f} "
        f"ms on the card (first calls; the head {cpu_s:.1f} s on the CPU), "
        f"{kept} detections kept")
    return errs


def _nce_on_card(dev):
    """nce at V 10,000, D 256, 10 negatives, B 256 on the card: its draws
    shared across the batch and in [0, V); Cost and the Input, Weight and
    Bias gradients against the CPU's nce_cost and grad rule at the card's
    own samples."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.nn_extra_ops import nce_cost

    rng = np.random.RandomState(34)
    B, D, V = 256, 256, 10000
    feeds = {"x": (0.1 * rng.randn(B, D)).astype(np.float32),
             "label": rng.randint(0, V, (B, 1)).astype(np.int64),
             "w": (0.1 * rng.randn(V, D)).astype(np.float32),
             "b": (0.1 * rng.randn(V)).astype(np.float32)}
    prog, fetch = op_program(
        pt, "nce", feeds, {"Input": "x", "Label": "label", "Weight": "w",
                           "Bias": "b"},
        {"Cost": ("float32", (B, 1)), "SampleLogits": ("float32", (B, 11)),
         "SampleLabels": ("int64", (B, 11))},
        {"num_neg_samples": 10, "num_total_classes": V}, ("x", "w", "b"))
    got = pt.Executor().run(prog, feed=_card_feed(feeds, dev),
                            fetch_list=fetch, scope=pt.Scope())
    ids = np.asarray(got[2])
    if not ((ids[:, 1:] == ids[:1, 1:]).all() and (ids >= 0).all()
            and (ids < V).all() and (ids[:, 0] == feeds["label"][:, 0]).all()):
        fail("nce on the card: samples not shared, out of range or labels "
             "not first")
    leaves = {k: torch.from_numpy(feeds[k]).requires_grad_(True)
              for k in ("x", "w", "b")}
    with torch.enable_grad():
        cost, logits = nce_cost(leaves["x"], leaves["w"], leaves["b"],
                                torch.from_numpy(ids), 10, V)
        # the program's loss: mean(Cost^2) + mean(SampleLogits^2)
        loss = (cost * cost).mean() + (logits * logits).mean()
        grads = torch.autograd.grad(loss, list(leaves.values()))
    want = [cost.detach(), logits.detach()] + list(grads)
    return {n: _compare_tail(f"nce {n}", g, w) for n, g, w in zip(
        ("Cost", "SampleLogits", "x@GRAD", "w@GRAD", "b@GRAD"),
        [got[0], got[1]] + got[3:], want)}


def _sampling_id_on_card(dev):
    """sampling_id's draws on the card: a chi-square over 20,000 draws of
    two rows, and never a zero-probability class."""
    import paddle_tpu_torch as pt

    probs = np.asarray([[0.1, 0.2, 0.3, 0.4], [0.7, 0.0, 0.1, 0.2]],
                       np.float32)
    reps = 10000
    feeds = {"p": np.repeat(probs, reps, 0)}
    prog, fetch = op_program(pt, "sampling_id", feeds, {"X": "p"},
                             {"Out": ("int64", (2 * reps,))})
    (ids,) = pt.Executor().run(prog, feed=_card_feed(feeds, dev),
                               fetch_list=fetch, scope=pt.Scope())
    ids = np.asarray(ids).reshape(2, reps)
    chi2 = []
    for row, p in zip(ids, probs):
        counts = np.bincount(row, minlength=4)
        if counts[p == 0].sum():
            fail("sampling_id on the card drew a class of probability 0")
        want = p[p > 0] * reps
        chi2.append(float(((counts[p > 0] - want) ** 2 / want).sum()))
    if max(chi2) >= 16.27:
        fail(f"sampling_id on the card: chi-square {chi2} (p = 0.001 gate "
             "16.27)")
    return chi2


LR_SCHEDULES = {
    "exponential_decay": lambda m: m.exponential_decay(0.1, 2, 0.5),
    "natural_exp_decay": lambda m: m.natural_exp_decay(0.1, 3, 0.4),
    "inverse_time_decay": lambda m: m.inverse_time_decay(
        0.1, 2, 0.5, staircase=True),
    "polynomial_decay": lambda m: m.polynomial_decay(0.1, 4, 0.01, power=2.0),
    "piecewise_decay": lambda m: m.piecewise_decay([2, 4], [0.1, 0.05, 0.01]),
}


def _lr_on_card(dev):
    """Each lr schedule drives Momentum(0.9) over an fc for 5 steps on the
    card and on the CPU from the same weights: the rate and the loss of
    every step agree."""
    import paddle_tpu_torch as pt

    rng = np.random.RandomState(35)
    feed = {"x": rng.randn(16, 8).astype(np.float32),
            "y": rng.randn(16, 1).astype(np.float32)}
    rates = {}
    for name, make in LR_SCHEDULES.items():
        pt.framework.reset_default_programs()
        x = pt.layers.data(name="x", shape=[8], dtype="float32")
        y = pt.layers.data(name="y", shape=[1], dtype="float32")
        pred = pt.layers.fc(input=x, size=1)
        loss = pt.layers.mean(pt.layers.square_error_cost(input=pred,
                                                          label=y))
        lr = make(pt.lr_scheduler)
        pt.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(loss)
        cpu, card = _cpu_and_card_scopes(pt.default_startup_program(), dev)
        seen = []
        for _ in range(5):
            w = pt.Executor(pt.CPUPlace()).run(
                pt.default_main_program(), feed=feed, fetch_list=[lr, loss],
                scope=cpu)
            g = pt.Executor().run(pt.default_main_program(),
                                  feed=_card_feed(feed, dev),
                                  fetch_list=[lr, loss], scope=card)
            for n, a, b in zip(("rate", "loss"), g, w):
                _compare_tail(f"{name} {n}", a, b)
            seen.append(float(np.asarray(g[0]).reshape(-1)[0]))
        rates[name] = seen
    return rates


def phase_op_tail(dev, smi):
    """15q: every op of the tail once on the card against the same program
    on the CPU path (``op_tail_cases``: outputs, and the gradients of
    mean(out^2) summed where the op has them), within OP_TAIL_TOL of
    max|CPU|, integer outputs exactly; the SSD300 head (``_ssd_on_card``),
    nce and sampling_id against their contracts, and each lr schedule over
    5 Momentum steps."""
    import paddle_tpu_torch as pt

    t0 = time.perf_counter()
    rng = np.random.RandomState(36)
    errs, secs = {}, {}
    for type_, feeds, inputs, outputs, attrs, grads in op_tail_cases(rng):
        prog, fetch = op_program(pt, type_, feeds, inputs, outputs, attrs,
                                 grads)
        t1 = time.perf_counter()
        want = pt.Executor(pt.CPUPlace()).run(prog, feed=feeds,
                                              fetch_list=fetch,
                                              scope=pt.Scope())
        t2 = time.perf_counter()
        got = pt.Executor().run(prog, feed=_card_feed(feeds, dev),
                                fetch_list=fetch, scope=pt.Scope())
        key = type_ + (" (ties)" if type_ in errs else "")
        secs[key] = (round(t2 - t1, 3), round(time.perf_counter() - t2, 3))
        errs[key] = max(_compare_tail(f"{key} {n}", g, w)
                        for n, g, w in zip(fetch, got, want))
    log(f"the op tail on the card: {len(errs)} ops against the CPU path, "
        f"max abs err {errs} (tolerance {OP_TAIL_TOL} of max); seconds "
        f"(CPU, card; first calls, outputs fetched) {secs}")
    ssd = _ssd_on_card(dev)
    nce = _nce_on_card(dev)
    chi2 = _sampling_id_on_card(dev)
    rates = _lr_on_card(dev)
    log(f"nce on the card at its own samples: max abs err {nce}; "
        f"sampling_id chi-square {chi2}; the lr schedules' rates over 5 "
        f"steps {rates}; 15q in {time.perf_counter() - t0:.1f} s on {smi}")
    return dict(ops=errs, ssd=ssd, nce=nce)


def graph_pools():
    """(pools, bytes): the CUDA graphs' private memory pools the caching
    allocator still holds, after freeing what nothing references (a dead
    graph's pool goes with it).  Every capture has a pool of its own."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pools = {}
    for seg in torch.cuda.memory_snapshot():
        pool = tuple(seg.get("segment_pool_id", (0, 0)))
        if pool != (0, 0):
            pools[pool] = pools.get(pool, 0) + seg["total_size"]
    return len(pools), sum(pools.values())


def timed(fn, *args, **kwargs):
    """Run one phase; log its seconds and what the Executors' CUDA places
    did in it, from the host events (``executor.capture`` with its pool
    and seconds, ``executor.eager_plan`` with the first reason), and the
    graph pools the allocator holds after it."""
    from paddle_tpu_torch.observability.events import GLOBAL_EVENTS

    ev0 = GLOBAL_EVENTS.now() * 1e6
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    tag = "".join(f", {k}={v}" for k, v in kwargs.items())
    log(f"[phase {fn.__name__}{tag}: {time.perf_counter() - t0:.1f} s]")
    events = [e for e in GLOBAL_EVENTS.events() if e["ts"] >= ev0]
    graphs = [e for e in events if e["name"] == "executor.capture"]
    eager = sorted({(e["args"]["program"], e["args"]["where"],
                     e["args"]["why"])
                    for e in events if e["name"] == "executor.eager_plan"})
    pools, pool_bytes = graph_pools()
    log(f"  graphs: {len(graphs)} captured ("
        + ", ".join(f"{e['args']['program']} pool "
                    f"{e['args']['pool_bytes'] / 2**20:.1f} MiB in "
                    f"{e['dur'] / 1e6:.2f} s" for e in graphs)
        + f"); {len(eager)} plans eager"
        + "".join(f"; {lbl} {where}: {why}" for lbl, where, why in eager)
        + f"; held after the phase: {pools} graph pools, "
        f"{pool_bytes / 2**20:.1f} MiB")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch finds no CUDA device")
    if not os.path.isdir(os.path.join(HERE, "paddle_tpu_torch", "csrc")):
        fail(f"no paddle_tpu_torch/ beside {__file__}: run from a checkout")
    sys.path.insert(0, HERE)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if sys.argv[1:] == [PROFILE_SEQ]:
        profile_sequence_steps()
        return
    if sys.argv[1:] == [PROFILE_TF]:
        profile_transformer_steps()
        return
    if sys.argv[1:] == [PROFILE_DEC]:
        profile_decode_step()
        return
    if sys.argv[1:] == [PROFILE_TAIL]:
        profile_tail_steps()
        return
    if sys.argv[1:] == [PROFILE_GRAPHS]:
        profile_graph_steps()
        return
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    from paddle_tpu_torch.kernels import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    log(f"nvcc: {nvcc}")
    t0 = time.perf_counter()
    built = _build.build()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s wall: " + ", ".join(
        f"{n} {s:.2f} s" for n, (s, _) in built.items()))
    for name, (_, text) in built.items():
        entry = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = ptxas_entry(line)
            elif ("registers" in line or "spill" in line
                  or "Performance" in line or "warning" in line):
                log(f"  {name} {entry}: {line.strip()}")
    # the f32 flash kernels' instruction mix at the transformer's D 128
    for kern in ("flash_fwd_tf32_kernel", "flash_dq_tf32_kernel",
                 "flash_dkv_tf32_kernel"):
        for fn, ops in _build.sass_opcodes("flash_attention", kern,
                                           "Li128ELb1E").items():
            n, mma = sum(ops.values()), ops.get("HMMA", 0)
            top = sorted(ops.items(), key=lambda kv: -kv[1])[:12]
            log(f"  {kern}<D 128, 16-byte loads> SASS: {n} instructions, "
                f"{mma} HMMA ({n / max(mma, 1):.1f} a product); "
                + ", ".join(f"{op} {c}" for op, c in top))
    from paddle_tpu_torch.kernels import conv as kconv
    from paddle_tpu_torch.kernels import matmul as kmatmul

    # the wgmma engine's instances as the card holds them (ptxas counts
    # a setmaxnreg kernel's registers before its warpgroups rebalance)
    for bn in (64, 128, 256):
        for what, attrs in (("matmul", kmatmul.wgmma_attributes(bn)),
                            ("conv, A by TMA", kconv.wgmma_attributes(
                                bn, False)),
                            ("conv, A gathered", kconv.wgmma_attributes(
                                bn, True)),
                            ("filter grad, A by TMA",
                             kconv.wgmma_attributes(bn, False, dw=True)),
                            ("filter grad, A gathered",
                             kconv.wgmma_attributes(bn, True, dw=True))):
            log(f"  wgmma engine, tile 128 x {bn} ({what}): {attrs}")
    # ... and the f32 matmul's, conv's and filter gradient's split-TF32
    # instances
    for bn in (64, 128):
        for what, attrs in (("matmul", kmatmul.wgmma_attributes(bn, True)),
                            ("conv, A by TMA", kconv.wgmma_attributes(
                                bn, False, tf32=True)),
                            ("conv, A gathered", kconv.wgmma_attributes(
                                bn, True, tf32=True)),
                            ("filter grad, A and B by TMA",
                             kconv.wgmma_attributes(bn, False, dw=True,
                                                    tf32=True))):
            log(f"  split-TF32 wgmma engine, tile 128 x {bn} ({what}): "
                f"{attrs}")

    import paddle_tpu_torch as pt

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(2026)

    # the model: full-width ResNet-50, random weights from a seed; the
    # serving export is its test clone, the training step the program
    main_prog, startup, pred, loss, params_grads = build_training_program()
    test_prog = main_prog.clone(for_test=True).prune([pred])
    serve_shapes = conv_shapes_of(test_prog, SERVE_BATCH)
    if sum(serve_shapes.values()) != 46:
        fail(f"ResNet-50 has {sum(serve_shapes.values())} kernel convs, "
             "not 46")
    want_launches = launches_implied(main_prog)
    log(f"launches the training program implies per step: {want_launches}")
    expect = dict.fromkeys(KERNELS, 0)
    expect.update(conv2d_nhwc=46, conv_bwd_input=46, conv_dw=46,
                  batch_norm_fwd=53, batch_norm_bwd=53, matmul=1, softmax=1)
    if want_launches != expect:
        fail(f"unexpected ResNet-50 training program: {want_launches}")
    want_amp = launches_implied(main_prog, amp=True)
    expect = dict.fromkeys(KERNELS, 0)
    expect.update(conv2d_nhwc_bf16=46, conv_bwd_input_bf16=46,
                  conv_dw_bf16=46, batch_norm_fwd_bf16=53,
                  batch_norm_bwd_bf16=53, matmul_bf16=1, softmax=1)
    if want_amp != expect:
        fail(f"unexpected ResNet-50 AMP training program: {want_amp}")

    # the image cells of benchmark/run.py: their work first
    image_programs = {name: build_image_program(name) for name in IMAGE_CELLS}
    timed(phase_image_work_guard, image_programs)

    kernels = timed(phase_kernels, dev, serve_shapes,
                    conv_shapes_of(main_prog, TRAIN_BATCH),
                    bn_shapes_of(main_prog, TRAIN_BATCH))
    image_kernels = timed(phase_image_kernels, dev, image_programs)

    exe = pt.Executor()   # CUDAPlace(0) by default
    scope = pt.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    calibrate_bn(test_prog, scope, {"img": rng.randn(
        8, 3, 224, 224).astype(np.float32)}, dev, seed=11)
    torch.cuda.synchronize()
    log(f"ResNet-50 initialised on {exe.place!r} and BN statistics set in "
        f"{time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = os.path.join(tmp, "resnet50")
        pt.io.save_inference_model(model_dir, ["img"], [pred], exe,
                                   main_program=main_prog, scope=scope)
        del exe, scope
        serve_launches, serve_wgmma = timed(phase_serving, dev, model_dir,
                                            rng)
        ops_launches, ops_wgmma = timed(phase_serving_ops, dev, model_dir,
                                        rng)
        img_per_s = timed(phase_throughput, dev, model_dir)
        serve_graph = timed(phase_serving_graph, dev, model_dir)

    timed(phase_train_parity, dev, main_prog, startup, loss, params_grads)
    train = timed(phase_train_step, dev, main_prog, startup, loss,
                  want_launches, smi)
    timed(phase_amp_parity, dev, main_prog, startup, loss)
    amp_train = timed(phase_train_step, dev, main_prog, startup, loss,
                      want_amp, smi, amp=True)
    for name in IMAGE_CELLS:
        timed(phase_image_parity, dev, name)
    timed(phase_image_dropout, dev, image_programs)
    image_steps = {}
    for name in IMAGE_CELLS:
        for amp in (False, True):
            path = f"{name}{'_amp' if amp else ''}_train_step"
            image_steps[path] = timed(phase_image_step, dev, name, smi,
                                      amp=amp)
    timed(phase_lenet, dev)
    timed(phase_lenet, dev, amp=True)

    timed(phase_tf_parity, dev)
    tf = timed(phase_tf_train_step, dev, smi)
    timed(phase_tf_converge, dev)
    timed(phase_tf_amp_parity, dev)
    tf_amp = timed(phase_tf_train_step, dev, smi, amp=True, f32=tf)
    timed(phase_tf_converge, dev, amp=True)
    graphs = timed(phase_executor_graphs, dev, smi)

    timed(phase_lstm_parity, dev)
    lstm = timed(phase_lstm_train_step, dev, smi)
    timed(phase_lstm_converge, dev)
    timed(phase_lstm_parity, dev, amp=True)
    lstm_amp = timed(phase_lstm_train_step, dev, smi, amp=True)
    timed(phase_lstm_converge, dev, amp=True)
    timed(phase_lod_parity, dev)
    lod = timed(phase_lod_train_step, dev, smi)
    timed(phase_wide_deep_parity, dev)
    wd = timed(phase_wide_deep_step, dev, smi)
    timed(phase_wide_deep_parity, dev, amp=True)
    wd_amp = timed(phase_wide_deep_step, dev, smi, amp=True)
    timed(phase_seq2seq_parity, dev)
    s2s = timed(phase_seq2seq_step, dev, smi)
    timed(phase_seq2seq_parity, dev, amp=True)
    s2s_amp = timed(phase_seq2seq_step, dev, smi, amp=True)
    demos = timed(phase_v1_demos, dev, smi)
    demos.update(timed(phase_fluid_demos, dev, smi))
    while_rnn = timed(phase_while_rnn, dev, smi)
    attention = timed(phase_ifelse_attention, dev, smi)
    bn_layouts = timed(phase_bn_layouts, dev, smi, while_rnn["lens"])
    beams = timed(phase_beams, dev, smi)
    srl = timed(phase_srl, dev, smi)
    text = timed(phase_text_conv, dev, smi)
    timed(phase_op_tail, dev, smi)
    demo_launches = {k: sum(r["launches"][k] for r in demos.values())
                     for k in KERNELS}
    log(f"the demos' launches in all: "
        f"{ {k: v for k, v in demo_launches.items() if v} }")
    for k in ("conv2d_nhwc", "conv_bwd_input", "conv_dw", "matmul",
              "softmax", "batch_norm_fwd", "batch_norm_bwd"):
        if not demo_launches[k]:
            fail(f"the demos launched no {k} kernel")
    idle = timed(phase_seq_profile)
    idle.update(timed(phase_tail_profile))
    lstm["idle_share"], lod["idle_share"] = idle["lstm"], idle["lod"]
    lstm_amp["idle_share"] = idle["lstm_amp"]
    wd["idle_share"] = idle["wide_deep"]
    wd_amp["idle_share"] = idle["wide_deep_amp"]
    s2s["idle_share"] = idle["seq2seq"]
    s2s_amp["idle_share"] = idle["seq2seq_amp"]
    srl["idle_share"], text["idle_share"] = idle["srl"], idle["text_conv"]

    model, dec_counts = timed(phase_decode_parity, dev)
    gen, gen_launches, refs, reqs = timed(phase_generate, dev, model, smi)
    spec = timed(phase_spec, dev, model, refs, reqs, smi)
    del model
    torch.cuda.empty_cache()
    gen.update(timed(phase_decode_profile))

    # each kernel's numbers are those of the path that runs it most: the
    # matmul and flash kernels the transformer step (their bf16 instances
    # its AMP step), the LSTM kernel the padded classifier's step (bf16:
    # its AMP step), the gather the LoD classifier's, the paged kernels the
    # decode step and the verify step, the conv and BN bf16 instances the
    # AMP ResNet-50 step (which the fused conv + BN statistics is counted
    # beside: no op calls it), the rest the f32 ResNet-50 step;
    # launches_by_path has every path's count
    by_path = {"train_step": train["launches"],
               "amp_train_step": amp_train["launches"],
               "serving": serve_launches,
               "serving_ops": ops_launches,
               "transformer_train_step": tf["launches"],
               "transformer_amp_train_step": tf_amp["launches"],
               "transformer_recompute_graph_step": graphs["launches"],
               "transformer_recompute_graph_amp_step":
                   graphs["launches_amp"],
               "lstm_train_step": lstm["launches"],
               "lstm_amp_train_step": lstm_amp["launches"],
               "lod_train_step": lod["launches"],
               "wide_deep_train_step": wd["launches"],
               "wide_deep_amp_train_step": wd_amp["launches"],
               "seq2seq_train_step": s2s["launches"],
               "seq2seq_amp_train_step": s2s_amp["launches"],
               "generate": gen_launches, **dec_counts,
               **{p: r["launches"] for p, r in image_steps.items()},
               **{f"demo_{n}": r["launches"] for n, r in demos.items()},
               "while_rnn": while_rnn["launches"],
               "ifelse_attention_train_step": attention["launches"],
               "bn_nhwc_step": bn_layouts["nhwc"],
               "bn_nchw_step": bn_layouts["nchw"],
               "bn_sequence_step": bn_layouts["sequence"],
               "beams": beams["launches"],
               "srl_train_step": srl["launches"],
               "text_conv_train_step": text["launches"]}
    main_path = {n: amp_train["launches"] for n in
                 list(BF16_OF.values()) + ["conv2d_bn_stats",
                                           "conv2d_bn_stats_bf16"]}
    main_path.update(matmul=tf["launches"], lstm=lstm["launches"],
                     lstm_bwd=lstm["launches"],
                     embedding=lod["launches"],
                     paged_attention=dec_counts["decode_step"],
                     paged_attention_chunk=dec_counts["verify_step"],
                     matmul_bf16=tf_amp["launches"],
                     lstm_bf16=lstm_amp["launches"],
                     lstm_bwd_bf16=lstm_amp["launches"],
                     **{f"flash_attention_{k}_bf16": tf_amp["launches"]
                        for k in ("fwd", "dq", "dkv")})
    # the matmul and conv launches on a wgmma engine, per path (the rest of
    # each path's launches ran on the SIMT or the mma.sync tile)
    wgmma_by_path = {"serving": serve_wgmma,
                     "serving_ops": ops_wgmma,
                     "train_step": train["wgmma"],
                     "amp_train_step": amp_train["wgmma"],
                     "transformer_train_step": tf["wgmma"],
                     "transformer_amp_train_step": tf_amp["wgmma"],
                     "transformer_recompute_graph_step": graphs["wgmma"],
                     "transformer_recompute_graph_amp_step":
                         graphs["wgmma_amp"],
                     "lstm_train_step": lstm["wgmma"],
                     "lstm_amp_train_step": lstm_amp["wgmma"],
                     "lod_train_step": lod["wgmma"],
                     "wide_deep_train_step": wd["wgmma"],
                     "wide_deep_amp_train_step": wd_amp["wgmma"],
                     "seq2seq_train_step": s2s["wgmma"],
                     "seq2seq_amp_train_step": s2s_amp["wgmma"],
                     "ifelse_attention_train_step": attention["wgmma"],
                     "srl_train_step": srl["wgmma"],
                     "text_conv_train_step": text["wgmma"],
                     **{p: r["wgmma"] for p, r in image_steps.items()}}
    main_wgmma = dict(matmul=tf["wgmma"], conv2d_nhwc=train["wgmma"],
                      conv_bwd_input=train["wgmma"], conv_dw=train["wgmma"],
                      matmul_bf16=tf_amp["wgmma"],
                      conv2d_nhwc_bf16=amp_train["wgmma"],
                      conv_bwd_input_bf16=amp_train["wgmma"],
                      conv_dw_bf16=amp_train["wgmma"])
    line = {"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name][0],
             replaces=KERNELS[name][1],
             launches=main_path.get(name, tf["launches"]
                                    if name.startswith("flash")
                                    else train["launches"])[name],
             launches_by_path={p: c[name] for p, c in by_path.items()},
             max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
             bound_ms=k["bound_ms"], bound_by=k["bound_by"],
             library_ms=k["library_ms"],
             **({"gather_sdpa_ms": k["gather_sdpa_ms"]}
                if "gather_sdpa_ms" in k else {}),
             **({"simt_ms": k["simt_ms"]} if "simt_ms" in k else {}),
             **{f: k[f] for f in ("bound_tf32_ms", "tile_ms", "conv_ms",
                                  "old_ms", "old_device_ms", "suffix_ms",
                                  "suffix_device_ms", "suffix_old_device_ms",
                                  "suffix_bound_ms", "t1_device_ms",
                                  "conv_device_ms",
                                  "split_pass_ms", "device_ms",
                                  "library_device_ms", "three_pass_ms",
                                  "three_pass_device_ms", "host_us",
                                  "moved_gb_per_s", "grid_ms",
                                  "grid_device_ms", "kernel_ms",
                                  "us_per_step", "clusters",
                                  "cluster_blocks", "resident",
                                  "kernel_route", "library_host_us",
                                  "cold_device_ms", "library_cold_device_ms",
                                  "wide_route", "wide_ms", "wide_device_ms",
                                  "wide_library_ms", "wide_library_device_ms",
                                  "wide_bound_ms", "sweep") if f in k},
             **({"launches_wgmma": main_wgmma[name][name],
                 "launches_wgmma_by_path": {p: c[name] for p, c in
                                            wgmma_by_path.items()}}
                if name in main_wgmma else {}),
             **({"mma_sync_ms": k["mma_sync_ms"]}
                if "mma_sync_ms" in k else {}),
             # the image cells' launches of this kernel at run.py's batch
             # (phase 2), by model
             **({"by_model": {m: r[name] for m, r in image_kernels.items()
                              if name in r}}
                if any(name in r for r in image_kernels.values()) else {}))
        for name, k in kernels.items()]}
    log(f"serving throughput: {img_per_s:.1f} images/s at bucket "
        f"{SERVE_BATCH}; ResNet-50 training: {train['images_per_s']:.1f} "
        f"images/s at batch {TRAIN_BATCH} (f32), peak "
        f"{train['peak_bytes'] / 2**30:.2f} GiB, idle share "
        f"{train['idle_share']:.3f}; under AMP (bf16) "
        f"{amp_train['images_per_s']:.1f} images/s, peak "
        f"{amp_train['peak_bytes'] / 2**30:.2f} GiB, idle share "
        f"{amp_train['idle_share']:.3f}; transformer LM training: "
        f"{tf['tokens_per_s']:.1f} tokens/s at B {TF_BATCH} S {TF_SEQ} (f32),"
        f" peak {tf['peak_bytes'] / 2**30:.2f} GiB, idle share "
        f"{tf['idle_share']:.3f}; under AMP (bf16) "
        f"{tf_amp['tokens_per_s']:.1f} tokens/s, peak "
        f"{tf_amp['peak_bytes'] / 2**30:.2f} GiB, idle share "
        f"{tf_amp['idle_share']:.3f}; recompute transformer step "
        + "; ".join(f"{kind} {r['tokens_per_s']:.1f} tokens/s, peak "
                    f"{r['peak_bytes'] / 2**30:.2f} GiB, idle share "
                    f"{r['idle_share']}"
                    for kind, r in (("f32 eager", graphs["f32_eager"]),
                                    ("f32 graphs", graphs["f32"]),
                                    ("AMP eager", graphs["amp_eager"]),
                                    ("AMP graphs", graphs["amp"])))
        + f"; Executor.run at bucket {SERVE_BATCH} eager "
        f"{serve_graph['eager_ms']:.3f} ms, graph "
        f"{serve_graph['graph_ms']:.3f} ms; LSTM classifier training: "
        f"{lstm['samples_per_s']:.1f} samples/s = "
        f"{lstm['tokens_per_s']:.1f} tokens/s at B {LSTM_BATCH} T {LSTM_SEQ}"
        f" (f32), peak {lstm['peak_bytes'] / 2**30:.3f} GiB, idle share "
        f"{lstm['idle_share']:.3f}; under AMP (bf16) "
        f"{lstm_amp['samples_per_s']:.1f} samples/s, peak "
        f"{lstm_amp['peak_bytes'] / 2**30:.3f} GiB, idle share "
        f"{lstm_amp['idle_share']:.3f}; LoD classifier training: "
        f"{lod['steps_per_s']:.2f} steps/s, peak "
        f"{lod['peak_bytes'] / 2**30:.3f} GiB, idle share "
        f"{lod['idle_share']:.3f}; /generate (decoder LM, d_model 2048, "
        f"16 slots): {gen['tokens_per_s']:.1f} tokens/s over the burst, "
        f"time to first token p50 {gen['ttft_p50_ms']:.1f} ms p99 "
        f"{gen['ttft_p99_ms']:.1f} ms, decode step {gen['step_ms_16']:.2f} "
        f"ms at 16 slots, peak {gen['peak_bytes'] / 2**30:.2f} GiB, idle "
        f"share {gen['idle_share']:.3f}; speculative {spec['tokens_per_s']:.1f}"
        f" tokens/s, acceptance {spec['accept_ratio']:.3f}; image cells of "
        "benchmark/run.py: "
        + "; ".join(f"{p[:-len('_train_step')]} {r['images_per_s']:.1f} "
                    f"images/s at batch {r['batch']}, peak "
                    f"{r['peak_bytes'] / 2**30:.2f} GiB, idle share "
                    f"{r['idle_share']:.3f}" for p, r in image_steps.items())
        + f"; wide_deep training: {wd['examples_per_s']:.1f} examples/s at "
        f"B {WD_BATCH} (f32), {wd['ms_per_step']:.3f} ms a step, peak "
        f"{wd['peak_bytes'] / 2**30:.3f} GiB, idle share "
        f"{wd['idle_share']:.3f}; under AMP (bf16) "
        f"{wd_amp['examples_per_s']:.1f} examples/s, "
        f"{wd_amp['ms_per_step']:.3f} ms a step, peak "
        f"{wd_amp['peak_bytes'] / 2**30:.3f} GiB, idle share "
        f"{wd_amp['idle_share']:.3f}"
        + "; seq2seq training: " + "; ".join(
            f"{kind} {r['tokens_per_s']:.1f} tokens/s at B {S2S_BATCH} S "
            f"{S2S_SEQ}, {r['ms_per_step']:.3f} ms a step, {r['tflops']:.2f} "
            f"model TFLOP/s, peak {r['peak_bytes'] / 2**30:.3f} GiB, idle "
            f"share {r['idle_share']:.3f}"
            for kind, r in (("f32", s2s), ("AMP (bf16)", s2s_amp)))
        + "; the demos: " + "; ".join(
            f"{n} {r['ms_per_step']:.3f} ms a step, "
            f"{r['samples_per_s']:.1f} samples/s, peak "
            f"{r['peak_bytes'] / 2**30:.3f} GiB" for n, r in demos.items())
        + f"; While dynamic RNN: {while_rnn['ms']:.3f} ms a batch of "
        f"{LOD_SEQS} sequences, {while_rnn['iterations']} iterations, "
        f"{while_rnn['condition_reads']} host reads of the condition, peak "
        f"{while_rnn['peak_bytes'] / 2**30:.3f} GiB; IfElse attention "
        f"training: {attention['ms_per_step']:.3f} ms a step, "
        f"{attention['samples_per_s']:.1f} samples/s, peak "
        f"{attention['peak_bytes'] / 2**30:.3f} GiB"
        + f"; SRL tagger training: {srl['ms_per_step']:.3f} ms a step, "
        f"{srl['sentences_per_s']:.1f} sentences/s at B {SRL_BATCH}, peak "
        f"{srl['peak_bytes'] / 2**30:.3f} GiB, idle share "
        f"{srl['idle_share']:.3f}; text conv training: "
        f"{text['ms_per_step']:.3f} ms a step, {text['samples_per_s']:.1f} "
        f"samples/s, peak {text['peak_bytes'] / 2**30:.3f} GiB, idle share "
        f"{text['idle_share']:.3f}"
        + f"; on {smi}; {time.perf_counter() - t_start:.1f} s in all")
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
