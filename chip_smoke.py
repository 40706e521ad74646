#!/usr/bin/env python3
"""Serve BERT-base (bf16 and int8), train BERT-base, ResNet-50 and the
Transformer NMT model and beam-search decode with it, train and serve
DeepFM (also from MultiSlot files through ``train_from_dataset``) and
train the MNIST MLP, train the book chapters (``examples/``) and serve
VGG-16, train BERT-base and transformer-base under their published
learning-rate schedules and run every dense op case, train BERT-base
under LAMB (with and without recompute), ResNet-50 under LARS and the MNIST
MLP under every update class and averaging wrapper, train BERT-base
accumulated over microbatches, transformer-base under mixed precision and
VGG-16 under a gradient penalty, train DeepFM from a stream under the step
guardian (preempted and resumed exactly) and ``examples/ctr_deepfm.py``'s
host-table model, autotune BERT-base's and ResNet-50's routes and serve
BERT-base to concurrent clients through ``PredictorPool``, train and serve
YOLOv3 at 608 x 608 and the three other detectors, train and serve
CRNN-CTC, and measure BERT-base's training and serving with the port's
measurement stack (goodput, MFU, memory, the anomaly detector, per-op
attribution, SLO alerts, ``fluid.profiler``), restart a BERT-base
serving replica cold and warm through the warm store, serve ResNet-50
through the C serving ABI beside the chaos CLI and the operator tools, and
train BERT-base eagerly through the dygraph tape, trace it and serve it,
through the PyTorch/CUDA port on one NVIDIA GPU, and hold its CUDA kernels
against their plain PyTorch versions.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA. Phases, each printing JSON lines:

1. device: the card, its power limit, the toolchain;
2. build: compile every kernel of ``paddle_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel; the native parser and the C serving ABI with
   ``g++`` beside them);
3. kernel vs plain: each kernel on the card at the main paths' shapes,
   against its plain version on the same inputs and against a second
   launch of itself (bit for bit), with times (CUDA events, median of 25
   single launches queued behind a busy GPU), the PyTorch library call
   that computes the same function (and the kernel's ratio to it), and the
   card's bound: ``flash_attn_fwd`` as serving calls it, ``flash_attn_fwd``
   with dropout and the LSE as training calls it, and ``flash_attn_bwd``
   (its fused variant at S <= 128, its split one at S 256, 512 and the
   ragged 200); then the device time of each kernel launch inside one
   ``flash_attn_fwd`` and one ``flash_attn_bwd`` call (``torch.profiler``);
4. serving path: build BERT-base (L12 H768 A12, bf16, random weights from a
   seed) with the port's DSL, run its startup program on the card, save it
   with ``save_inference_model``, load it into a ``Predictor`` (its
   executable cache: one CUDA graph per request signature) and answer
   4 requests of 8 x 128 tokens and 2 of 8 x 512 with ragged masks; checks
   that every kernel of the path launched (``flash_attn_fwd``: 12 per
   request, counted on each graph replay), that the outputs are finite,
   bit-equal to the eager op-by-op run of the same Predictor
   (``_use_graphs = False``), and that the first request agrees with the
   plain attention on the card and with the CPU Predictor (the plain
   path); then, for graph and eager in the same call, the wall time and
   the profiler's idle share at each shape, the graphs captured with the
   device memory each holds, and one replay's kernels against its counts;
5. training path: BERT-base pretraining at bench.py's configuration (batch
   128, S 128, 2560 masked positions, bf16, dropout 0.1, Adam 1e-4, seed 0)
   built with ``append_backward`` and ``Adam.minimize``, startup on the
   card, a few steps on one repeated batch, on the executor's path (each
   forward op once, its grad op differentiating the kept graph; the 158
   ``adam`` ops as one ``multi_tensor_update`` launch) and on the eager
   reference path (``_reuse_forward = _group_updates = False``: each
   generic grad op recomputes its forward, one ``adam`` op at a time) in
   the same call; checks the launches per step (``flash_attn_fwd`` 12,
   ``flash_attn_bwd`` 12, ``multi_tensor_update`` 1; the reference 24, 12,
   0), finite losses that fall, the two paths' step-1 losses bit for bit
   and their gaps after the steps within the limits below (the reference
   path, run twice, parts from itself by as much: the card's backward sums
   some gradients with atomics), and step 1 against two references from
   the same weights: the
   card's ``attn_impl="composed"`` program (plain matmul/softmax
   attention) and, at batch 2 with the same attention-dropout masks, the
   CPU port; prints step ms, peak memory and the profiler's breakdown of
   each path;
6. conv1x1_bn and int8_matmul against their plain versions (CUDA events,
   as in phase 3): ``conv1x1_bn`` at the 12 distinct (M, K, N) shapes of
   ResNet-50's 33 fused chains at batch 128 (read from the program), with
   the prologue at one shape and at two ragged ones, and a ragged M under
   16 column blocks at K 2048; ``int8_matmul`` at
   the 8 shapes of int8 BERT-base serving (4 fc shapes x M 1024 and 4096),
   ragged shapes (unaligned rows and N, M 1 and 8, a K off the 64-deep K
   stage) and f32, held bit for bit (outputs, row scales, codes); every K2
   and K3 case also against a second launch (bit for bit) and with its
   ratio to the bf16 ``torch.matmul`` of its shape; then the device time
   of each launch inside one call of each (``torch.profiler``);
7. int8 serving path: the same BERT-base weights quantized with
   ``quantize_weights(int8_compute=True)``, saved, loaded into a
   ``Predictor`` on the card and asked phase 4's requests; checks the
   launches (``int8_matmul`` 48 per request, ``flash_attn_fwd`` 12), the
   outputs bit-equal to the eager run, and the first request against the
   same model with the plain int8 matmul on the card (bit for bit), the
   CPU Predictor (on its first 2 sequences) and the unquantized bf16 model
   (the int8 accuracy cost);
   graph and eager timed and profiled as in phase 4;
8. ResNet-50 training at bench.py's configuration (batch 128, 224 x 224,
   bf16, NHWC, space-to-depth stem, 1000 classes, Momentum(0.1, 0.9), seed
   0, one repeated batch), every batch norm marked ``fuse_stats`` and
   ``fuse_conv_bn_stats`` run before ``minimize`` (33 chains), on the
   executor's path and on the eager reference path in the same call;
   checks the launches per step (``fused_conv1x1_bn_fwd`` 33, the 33
   forward ops, and ``multi_tensor_update`` 1; the reference 66: the 33
   recomputes inside the generic grad too), finite losses that fall, the
   two paths' losses within the limit below and their states' bit-equality
   printed, and step 1 against the unfused program on the card
   and, at batch 2, the CPU port, in bf16 and on the f32 build of the same
   weights; prints step ms, peak memory and each path's breakdown;
9. multi_tensor_update over BERT-base's 158 Adam parameters,
   ResNet-50's 161 Momentum parameters, BERT-base's 158 LAMB parameters and
   ResNet-50's 161 LARS parameters (phase 18's kinds), DeepFM's 10 Adam parameters (17.5 M
   elements, the 1,000,000 x 16 table among them), ``examples/ctr_deepfm.py``'s
   dense Adam parameters (phase 20 B; its table is on the host), the MNIST MLP's 6 SGD
   parameters, transformer-base's 258 Adam parameters and each book
   chapter's list of phase 16 (their shapes and dtypes read from the
   programs), in place, against the per-op lowerings on the card, bit
   for bit, with its time, its bound, the per-op path's time (device and
   host), its own host time per call and ``torch._fused_adam_`` /
   ``torch._fused_sgd_`` on f32 copies of the same tensors as yardsticks;
10. (run after phase 3) the run counter on the card: K1-fwd, K1-bwd and
   the dropout kernel given a ``DeviceSeed`` draw bit for bit what they
   draw for the host
   seed of the same counter (0, 1, 2^31, 2^32 + 5), and two counters two
   masks; the dropout kernel against its plain version, bit for bit, at
   BERT-base's hidden-dropout shape ([16384, 768] bf16, p 0.1, both
   implementations), at transformer-base's attention-probs shape and at
   VGG-16's fc dropout in the image chapter ([128, 4096] f32, p 0.5,
   ``downgrade_in_infer``), in f32, ragged, unaligned and at p 0 and 1,
   with its time, bound and ``F.dropout``'s time at the three path shapes;
   the gradients of
   ``lookup_table_v2`` and ``gather`` at BERT-base's shapes and of DeepFM's
   two 1,000,000-row tables at 106,496 ids, PyTorch's (atomics) against the
   port's ``RowGather``, timed, each run twice;
11. captured training (the phases printed last): BERT-base at phase 5's
   configuration and ResNet-50 at phase 8's, the graph executor (one CUDA
   graph per step, replayed) against the eager executor
   (``_use_graphs = False``) from the same state: 5 steps, launches per
   step, losses and every state tensor bit for bit (BERT's eager path run
   twice shows it reproduces), a dropout op's Mask equal between paths at
   steps 1 and 2 and different between them; ``run_fused`` with K = 4
   against 4 ``run`` calls; then each path's step ms (median of the warm
   steps), peak memory, graph pool, device busy ms, idle share profiled
   and unprofiled and device activities; and the eager step's peak and the
   graph's pool with every intermediate kept to the step's end against
   freed after its last reader;
13. (run after phase 11) Transformer NMT: transformer-base as
   ``bench_workloads.py`` builds it (vocabularies 32000, hidden 512, 6 + 6
   layers, 8 heads, FFN 2048, dropout 0.1 (50 ``dropout`` ops), label
   smoothing 0.1, Adam 1e-4, f32, B64, source and target length 64, seed
   0, one repeated batch), trained as phase 11 trains its models (graph
   against eager over 5 steps and under ``run_fused`` K = 4, bit for bit;
   ``dropout_fwd`` 50 and ``multi_tensor_update`` 1 a step; losses finite
   and falling; step ms, tokens/s, peak memory, graph pool, device busy
   ms, idle share, device time by kind), with step 1 held against the CPU
   port at batch 2 on the dropout-0 build of the same weights; then
   ``beam_decode`` (beam 4, ``max_len`` 16, bos 0, eos 1, 8 sentences of
   length 64 with ragged masks: one ``scan`` over a sub-block, captured as
   one CUDA graph) on the trained weights carried by name: graph against
   eager bit for bit, the card against the CPU port at batch 2 (ids equal,
   or parted only on a near-tie of the CPU's candidates), beams
   best-first, beam 4 against greedy; decode ms, generated tokens/s, idle
   share, launches;
14. (run after phase 13) DeepFM CTR as ``bench_workloads.py`` builds it
   (B 4096, 26 fields over a vocabulary of 1,000,000, embedding 16, 13
   dense features, tower 400-400-400, the ``auc`` metric with 4095
   thresholds, ``Adam(1e-3)``, f32, seed 0, one repeated batch), trained as
   phase 11 trains its models and also against the eager reference path:
   losses, AUC fetches and every state tensor (tables, tower, Adam's
   accumulators, the AUC histograms) bit for bit over 5 steps,
   ``run_fused`` K = 4, ``multi_tensor_update`` 1 a step, the histograms
   holding 4096 examples for each step taken, the fetched AUC against
   numpy's from the fetched probabilities, step 1 against the CPU port;
   step ms, examples/s, idle share and device time by kind (the row
   gradients, the update and the matmuls apart); then the trained model
   saved with ``save_inference_model`` (ids and dense in, prob out) and
   served by the Predictor at B 4096 and B 64 through its CUDA graphs
   (bit-equal to eager, against the CPU Predictor, latency per shape).
   Then the MNIST MLP (784-128-64-10, B 256, ``SGD(0.01)``, random images
   from seed 0): the same checks, its 6 ``sgd`` ops one
   ``multi_tensor_update`` launch a step, the loss falling over 20 steps,
   step 1 against the CPU port; and the same MLP with
   ``GradientClipByGlobalNorm(1.0)`` and ``L2Decay(1e-4)``, graph against
   eager bit for bit and step 1 against the CPU port;
15. (run after phase 14) DeepFM trained from MultiSlot files, at
   ``bench_workloads.py:137-263``'s end-to-end configuration: 200,000 rows
   in 8 part files written from seed 0 (~55 MB of text, removed after),
   ``QueueDataset`` (B 4096, ``set_thread(4)``, ``drop_last``: 48 batches)
   over phase 14's DeepFM. Epochs, each from the startup state with the
   step's signature warmed and captured first: parse only (every part file
   through the native parser, which the build phase compiled with ``g++``;
   the C++ calls timed apart), the steps over the parsed batches (compute
   only), ``Executor.run`` over ``_iter_batches()`` (serial),
   ``train_from_dataset`` (prefetch; then profiled for the device's busy
   time and the idle share) and ``train_from_dataset(fuse_steps=4)``: each
   epoch's seconds, examples/s and ``multi_tensor_update`` launches (48),
   every state tensor bit for bit to the serial loop's; then
   ``infer_from_dataset`` over the files (no state changes, its last
   ``prob`` equal to ``run(use_prune=True)``'s) and ``save_persistables``
   / ``load_persistables`` into a fresh scope (one more step equal to the
   live scope's, bit for bit);
16. (run after phase 15) the book chapters, each at its example's
   configuration and schedule (``paddle_tpu_torch/tools/book.py``), on the
   port's loaders pointed at a fresh, empty ``PADDLE_TPU_DATA_HOME`` (their
   surrogates): mnist_mlp, fit_a_line, word2vec, understand_sentiment (a
   96-step ``dynamic_lstm`` trained through ``scan``), label_semantic_roles
   (two bidirectional LSTM layers and the CRF), recommender_system,
   machine_translation and image_classification (VGG-16 with batch norm at
   B 128, ``Adam(1e-3)``). For each: the first 4 steps graph against eager,
   bit for bit (losses, the fetched metric, every state tensor), with
   ``multi_tensor_update`` 1 a step (and ``dropout_fwd`` 2 for VGG); step 1
   against the CPU port from the same weights; the example's schedule on
   the graph executor (losses finite and falling, the step ms, peak memory
   and graph pool); the example's final metric held to the example's own
   bar; the eager step ms and three profiled steps (busy ms, idle share,
   activities). Then ``crf_decoding``'s ties on the card, and VGG-16 served at
   bench_inference.py's 3 x 224 x 224, f32 and bf16 from one set of
   weights, mb 1 and 32, through the Predictor, each fed the same images
   as a tensor on the card: graph and eager latency (median of 10), the
   graph pools, graph against eager bit for bit, f32 mb 1 against the CPU
   Predictor, bf16 against f32, and at mb 32 the latency with
   ``cudnn.deterministic`` off;
17. (run after phase 16) training under a learning-rate schedule:
   BERT-base at phase 11's configuration under BERT's published schedule
   (``linear_lr_warmup(polynomial_decay(1e-4, 1e6, 0), 10000, 0, 1e-4)``,
   the step counter preset to 9994, so that its 4 steps cross the end of
   the warmup; nested, the schedule advances the counter by 2 a step, as
   in the JAX package), and transformer-base at phase 13's under
   ``noam_decay(512, 4000)`` (the counter at 3997: its steps cross the
   peak). For each, 4 steps on the eager executor, on the graph executor
   and in one ``run_fused`` call, from one state: the learning rate, the
   counter and the loss of every step and every state tensor bit for bit
   across the three, the learning rate against its float64 closed form
   (``train_profile.bert_schedule_lr`` / ``noam_schedule_lr``), the
   launches of each path (K1-fwd, K1-bwd, ``dropout``,
   ``multi_tensor_update``), the multi-tensor work tables each path built,
   step 1 against the CPU port at batch 2 (phase 5's and phase 13's
   limits), and the step ms, device busy ms and activities beside the
   constant-LR step of phases 11 and 13. Then every case of
   ``paddle_tpu_torch/tools/op_cases.py`` (the dense op families: each
   activation, elementwise, reduction, basic, tensor and math op type) on
   the card against the CPU port, forward and gradient, with the case's
   tolerance (the 13 optimizer update ops' cases among them: f32, a ragged
   shape and a bf16 parameter beside f32 state); each case whose gradient
   or update adds rows by index run twice on the card, bit for bit; the
   random ops and ``dpsgd``'s noise held by their statistics;
18. (run after phase 17) the optimizer surface. A: BERT-base at phase 11's
   configuration under ``Lamb`` at its defaults (weight decay 0.01, beta1
   0.9, beta2 0.999, epsilon 1e-6), LayerNorm scales and biases excluded
   from weight decay, under BERT's schedule from the counter phase 17
   presets; B: A under ``RecomputeOptimizer`` with a checkpoint at each of
   the 12 encoder layers' outputs (12 ``remat_segment`` ops); C: ResNet-50
   at phase 8's configuration under ``LarsMomentum(0.1, 0.9)`` at its
   defaults. Each as phase 17 runs its models: 4 steps eager, graph and
   ``run_fused`` from one state, losses and every state tensor bit for bit,
   the launches of each path (K1-fwd 12 a step on A and 24 on B, K1-bwd 12,
   ``dropout`` 25 and 50, K2 33 on C, ``multi_tensor_update`` 1: its
   ``lamb`` kind's 3 kernels, its ``lars_momentum`` kind's 2), the work
   tables built, step 1 against the CPU port at batch 2 (phase 5's limits;
   phase 8's f32-update rule for C), step ms, busy ms, activities and
   graph pool beside phase 11's constant-LR Adam and Momentum steps; B
   against A after the 4 steps (limits below) and B's graph pool below
   A's. D: the MNIST MLP under ``AdamW``, ``Adagrad``, ``Adamax``,
   ``Adadelta``, ``RMSProp`` (centered), ``Ftrl``, ``DecayedAdagrad``,
   ``Lamb`` and ``LarsMomentum``, and under ``ExponentialMovingAverage``,
   ``ModelAverage`` and ``LookaheadOptimizer`` over ``Adam``: graph against
   eager bit for bit, the loss finite and falling, the wrappers'
   ``apply()`` / ``restore()`` against numpy's arithmetic over the scope.
   Phase 9 holds ``multi_tensor_update``'s ``lamb`` kind over BERT-base's
   158 parameters (52 of them excluded from weight decay, one run) and its
   ``lars_momentum`` kind over ResNet-50's 161: the moments bit for bit to
   the per-op lowerings, each tensor's norms within 1e-6 relative of
   ``torch.sum``'s, ParamOut within 2 f32 ulps (1 bf16 ulp) and bit for bit
   to the same arithmetic fed the kernel's norms, two runs bit for bit;
19. (run after phase 18) the rest of the training surface. A: BERT-base
   at phase 11's configuration under ``PipelineOptimizer(Adam,
   num_microbatches=4, schedule="scan")``: the global batch of 128 as 4 x
   32 in one ``scan`` whose body holds the forward and backward ops, the
   masked positions rebased to each microbatch
   (``train_profile.pretrain_feed(..., microbatches=4)``); as phase 17 runs
   its models, without ``run_fused`` (eager and graph from one state bit for
   bit, K1-fwd and K1-bwd 48 a step, each forward once a microbatch,
   ``dropout`` 100, ``multi_tensor_update`` 1), step ms, busy ms, activities, graph
   pool and eager peak beside phase 11's plain B128 step, and K1's time a
   launch inside the scan from the trace; A0: at dropout 0 against the
   plain B128 step at dropout 0 on the same tokens, 4 steps from one
   state, held to phase 5's limits. B: transformer-base at phase 13's
   configuration under ``contrib.mixed_precision.decorate(Adam)`` at its
   defaults (bf16 products, no loss scaling), as A, beside phase 13's f32
   step, with the casts inserted, the products' dtypes and device ms, and
   step 1's loss against the f32 program's (limit below). B2: the MNIST
   MLP under fp16 dynamic loss scaling for 6 steps with an inf in step 3's
   batch: the scale sequence equal to its closed form on the eager, graph
   and CPU paths, the parameters unchanged by the overflowed step, graph
   against eager bit for bit. C: the image chapter (VGG-16-BN, B 128, 3 x
   32 x 32, dropout 0.5) under the input-gradient penalty
   (``book.build_image_penalty``: second order through cuDNN's conv2d,
   batch norm, pooling and the ``dropout`` kernel's Function) as A,
   fetching the penalty, which must fall, beside the plain chapter's step.
   D: the 12 second-order op cases of ``tools/double_grad.py`` on the card
   against the CPU port, the second-order refusals of K1's and K2's
   Functions on the card, the composed attention's second order, and the
   WGAN-GP objective over 200 steps (5 against the CPU port). Alone:
   ``python3 -c "import torch, chip_smoke as cs; cs.phase_build();
   cs.phase_training_surface(torch)"``, which times its yardsticks itself;
20. (run after phase 19) streaming, checkpoints, the step guardian and the
   host table. A: DeepFM at phase 14's configuration from phase 15's 8 part
   files, one ``FileTailSource`` each, merged in a fixed rotation
   (``StreamingDataset(ordered=True)``), under ``StepGuardian`` with an
   async ``Checkpointer`` every 4 steps, captured: 16 steps with a
   transient ``exc`` at dispatch (retried) and a ``corrupt`` record at
   parse (quarantined); a restore of the last periodic checkpoint into the
   live, captured scope, rerun to step 16 (bit for bit, no recapture); the
   same faults with a ``preempt`` at step 8, then a fresh executor and
   dataset that ``restore()``, ``seek`` the watermark and run to step 16:
   every state tensor (parameters, Adam moments, ``auc``'s histograms) and
   the run counter bit for bit to the uninterrupted run; step 1 against
   the CPU port; the guarded step ms beside phase 14's, the stream's
   records/s, the resumed run's idle share, the checkpoint's blocked and
   write seconds, the restore's. Then the default merge (arrival order, the
   JAX package's) preempted at step 4 and resumed to step 8: the batches
   trained hold each record of a prefix of each file exactly once.
   B: ``examples/ctr_deepfm.py``'s program
   (``host_embedding`` with Adagrad, 256-128, Adam) at the example's
   constants (vocabulary 20,000, B 512, 50 steps: the loss falls) and at
   A's scale (vocabulary 1,000,000, B 4096, 12 steps: a 64 MB table and its
   64 MB accumulator), eager and captured from one state: losses, dense
   state, table and accumulator bit for bit, ``push_count``, a third,
   captured run under ``StepGuardian`` with a transient ``exc`` at
   ``fetch`` (after the step: undone, then retried) bit for bit to the
   clean one, ``run_fused`` refused with the JAX reason, ``save_all`` / ``load_all`` round-tripped,
   step 1 (the dense update and the table's) against the CPU port, the
   host ms of the gather and the push a step (the push's parts from
   ``HostTable._apply``'s own spans, ``host_table_push_seconds``), busy ms
   and idle share.
   Alone: ``python3 -c "import torch, chip_smoke as cs; cs.phase_build();
   cs.phase_stream_and_host_table(torch, 'build')"`` after ``mkdir -p
   build``;
21. (run after phase 20) the tuner and the serving tier, with the
   autotune cache pinned to a fresh file under ``build/`` for the whole
   run (so phases 1-20 run the defaults). K1-fwd's 64- and 128-row tiles
   against ``attention_plain`` and each other (bit for bit) at B8 S512 and
   B128 S128 beside the bound; A: ``tune_program`` in search over
   BERT-base's serving program (S 128 and 512, row buckets 1-8) and
   ResNet-50's training program, every decision with each candidate's
   CUDA-event time (on the card the backend choices' one candidate is the
   kernel: no plain chain is a route there); B: ``train_from_dataset(fuse_steps=0)`` under search on
   phase 15's DeepFM files, then ``fuse_steps=K`` at its K, bit for bit;
   C: BERT-base behind ``PredictorPool(size=2, max_batch=8,
   max_wait_ms=2.0)``: a cold S 512 signature captured beside live
   replays, 96 ragged requests from 8 threads and 3 tenants against solo
   runs (byte-equal count, at most 1 bf16 ULP), 12 K1-fwd launches a
   replay, no capture in traffic, p50 / p99 ms, requests/s and idle share;
   a hot swap under load (no capture, each output one model's); a
   ``serve_dispatch`` fault on one tenant (typed errors, its breaker
   open, the rest served); ``dtype="auto"`` under search; the drain. Then
   3.19's ``top_k`` rows on the card and an out-of-range gather in a
   child process. Alone: ``python3 -c "import torch, chip_smoke as cs;
   cs.phase_build(); cs.phase_serving_tier(torch, 'build')"`` after
   ``mkdir -p build``;
22. (run after phase 21, before its autotune cache is removed) object
   detection, f32 with TF32 off. A: YOLOv3 (DarkNet-53 at the JAX model's
   defaults, 80 classes) at PaddleDetection's ``yolov3_darknet.yml`` COCO
   sizes, 608 x 608, batch 8, 50 gt rows an image (seeded images and boxes,
   some rows padded, pairs of gts sharing a cell), 5 Adam steps through the
   captured step against the same 5 run eagerly, losses and every state
   tensor bit for bit, the losses finite and falling; step ms, busy ms,
   idle share, launches a step, the graph pool, beside the f32 bound of
   3 x 141 GFLOP an image. B: ``yolov3_infer`` with the trained weights
   through ``save_inference_model`` to the port's ``Predictor`` at batch 1
   and 8 (``conf_thresh`` 0.01, K 400, ``keep_top_k`` 100): no capture in
   warm traffic, p50 ms, busy ms, the ``multiclass_nms`` sweep alone as a
   graph of its own (its device ms and launches) and the network's ms
   apart; batch 1 against the CPU Predictor by the gap rule
   (``_dets_agree``). C: Faster R-CNN, RetinaNet and Mask R-CNN at their
   JAX tests' sizes, 3 captured Adam steps each against the CPU port's and
   one served batch against the CPU Predictor. D: every case of
   ``tools/detection_cases.py`` on the card against the CPU port, each
   card call also captured as a CUDA graph (a host sync would raise) with
   its launches counted, and the gradients of ``roi_align``,
   ``yolov3_loss`` and the bilinear resize. Every detection op type must
   have run on the card (a table of calls and launches a call by path).
   Alone: ``python3 -c "import tempfile, torch, chip_smoke as cs;
   cs.phase_build(); cs.phase_detection(torch, tempfile.mkdtemp(dir='build'))"``
   after ``mkdir -p build``;
11b. phase 23, the rest of vision and control flow. A: the While of
   ``tests/test_control_flow_dsl.py``'s MT-book test (an fc in the body) at
   width 512, batch 128, ``max_iters`` 32 (24 live runs), 5 Adam steps
   through the captured step, bit for bit to eager, step 1 against the CPU
   port at batch 2; a While without ``max_iters`` refused capture (the
   reason printed, naming ``while``), run eagerly, equal to the CPU port,
   its device activities a run; an IfElse over rows (half true) and a
   Switch on a fed value, a different case each step, captured, bit for
   bit to eager; an LSTM written with DynamicRNN over the sentiment
   chapter's first feed at ``examples/understand_sentiment.py``'s widths,
   5 captured steps. B: ResNet-50 at phase 8's configuration with 50% of
   its conv weights pruned by magnitude (``contrib.slim``), 5 captured
   steps, every pruned entry exactly 0 after each, K2's launches a step
   equal to the fuse pass's 33 chains, the step ms beside phase 8's; then
   ``examples/prune_finetune.py``'s convnet to its bar. C: every case of
   ``tools/vision_cases.py`` at its models' shapes against the CPU port,
   forward and gradient, each captured with its launches counted; step 1
   of the NCHW space-to-depth ResNet-50 at batch 2 against the CPU port.
   Alone: ``mkdir -p build; python3 -c "import tempfile, torch, chip_smoke
   as cs, paddle_tpu_torch as pt; cs.phase_build();
   cs.phase_slim_and_control_flow(torch, cs.book_setup(pt,
   tempfile.mkdtemp(dir='build')))"``;
11c. phase 24, CRNN-CTC text recognition and the op types of ROADMAP item
   8. A: ``tools/ocr.py``'s CRNN-CTC at crnn_ctc_model.py's width ([1, 48,
   512] images, T 64, 96 classes, hidden 200), batch 32, Momentum: 5
   captured steps bit for bit to the same 5 eager, step ms on both paths,
   busy ms, idle share, launches a step, the graph's pool,
   ``multi_tensor_update`` the same calls each step; step 1 at batch 2 against the CPU
   port. B: the decode program (``ctc_greedy_decoder``) on a seeded state at
   a trained net's scales through ``save_inference_model`` to the
   ``Predictor`` at batch 1 and 32 (p50 ms, device activities a request):
   every row decodes tokens, and the logits, ids and lengths equal the
   executor's bit for bit; the on-card ``edit_distance`` equal to a numpy
   Levenshtein, normalized and not. C: every case of
   ``tools/extra_op_cases.py`` on the card against the CPU port, forward and
   gradient, each captured with its launches counted (an empty graph only
   for the views and constants of ``OCR_EMPTY_CAPTURES``; ``py_func``
   refused capture, its reason printed), each
   ``scatters`` case twice, bit for bit; ``data_norm``, ``center_loss``,
   ``spectral_norm`` and a batch-like draw in a captured SGD step, bit for
   bit to eager, the draw new at each replay. D: ``warpctc`` forward + backward
   beside ``F.ctc_loss`` at [32, 64, 96], L 24, losses and gradients held
   to it. Alone: ``mkdir -p build;
   python3 -c "import tempfile, torch, chip_smoke as cs; cs.phase_build();
   cs.phase_ocr(torch, tempfile.mkdtemp(dir='build'))"``;
11d. phase 25, the measurement stack on BERT-base, under ``PADDLE_TPU_OBS=1``.
   A: phase 11's captured B128 S128 bf16 Adam step, 20 warm steps after the
   warm-up and the capture, one async checkpoint save and one injected
   ``hang@dispatch`` (about 5 warm steps long): the goodput ledger's causes
   against its wall (within 1%), ``program_flops`` against a hand count of
   BERT's matmul FLOPs (within 1%), ``program_mfu`` in (0, 1) against the
   named peak, the memory gauges, the detector's flagged steps (the hang's
   only), K1-fwd and K1-bwd 12 launches a warm step. B: the attribution of
   A's capture miss (its profiled eager warm-up): the top 10 IR ops by
   device time and the attributed fraction; K1's kernels under
   ``fused_attention`` ops and their grads only. C: BERT-base behind
   ``PredictorPool(size=2, max_batch=8)`` with ``PADDLE_TPU_OBS_SLO`` rules (a
   p99 latency rule on ``serving_request_seconds{tenant}``, no nonfinite
   tensors): a ``serve_hang`` fires the p99 page and it resolves after;
   ``/alerts`` and ``/goodput`` answer 200 and equal ``slo.alerts_doc()`` and
   the ledger; every output byte-equal to its solo run; the pool's warm-up
   captures in the ledger's compile. D: ``fluid.profiler`` around 3
   captured steps of A: the exported Chrome trace holds K1's kernels inside
   the executor's spans (one clock), and a warm-up inside the session skips
   its attribution. Alone: ``mkdir -p build; python3 -c "import tempfile,
   torch, chip_smoke as cs; cs.phase_build();
   cs.phase_measurement_stack(torch, tempfile.mkdtemp(dir='build'))"``;
11e. phase 26, the static verifier (``paddle_tpu_torch/analysis/``). A: the
   full-width programs of phases 5, 8, 13, 14, 22 and 24 (BERT-base
   pretraining, ResNet-50, transformer-base, DeepFM, YOLOv3 at 608 x 608,
   CRNN-CTC) verified with their fetches: zero error findings, each
   program's op count, findings by code and ``verify`` seconds. B: phase
   11's BERT-base step under ``PADDLE_TPU_VALIDATE=raise`` and
   ``PADDLE_TPU_MEM_BUDGET=40G``, one miss and 5 replays: one ``verify``
   journal event and span (none in the replays), the goodput ledger's
   ``verify`` cause equal to that span, K1-fwd and K1-bwd 12 launches a
   replay, ``program_static_peak_bytes`` equal to ``estimate_program_memory``
   to the byte, ``program_static_peak_ratio`` printed. C: a fresh copy of the
   program under an 8G budget raises ``VerificationError`` with PT051 before
   its warm-up: no kernel launched, no graph captured, the scope's state
   bit for bit unchanged. D: ``layout_churn`` (PT060) over phase 25 B's
   attribution of the BERT warm-up (no second profiler session): each
   finding names an op the attribution holds. Alone (D needs phase 25's
   program, and is skipped): ``mkdir -p build; python3 -c "import torch,
   chip_smoke as cs; cs.phase_build(); cs.phase_analysis(torch, None)"``;
11f. phase 27, the warm store (``paddle_tpu_torch/warmstore/``) and the
   fluid helpers. A: phase 4's BERT-base (bf16) served by a
   ``PredictorPool`` (max_batch 8) in a child process started from a fresh
   copy of the checkout (no ``csrc/build``) with ``PADDLE_TPU_WARMSTORE`` at
   a new root: cold (an empty store), then warm (the store the cold child
   wrote), each timed by part (import, model load, ``nvcc``, each bucket's
   eager first run and capture, the first answer). Held: the warm child
   runs no ``nvcc`` and restores each kernel from tier A under a passing
   probe verdict; both capture every bucket, K1-fwd 12 launches a replay;
   each bucket's output byte-equal between the children and this process's
   ``Predictor``; ``warmstore verify`` rc 0. Then, in a copy of that store,
   the library is corrupted by ``faults.mutate_warmstore``: a third child
   quarantines it, builds the kernel with ``nvcc`` from the sources and
   answers byte-equal.
   B: ``install_check.run_check()`` on the card (``multi_tensor_update``'s
   ``sgd`` kind) and ``nets.scaled_dot_product_attention`` at B 8, S 512,
   768 wide, 12 heads, f32, against the program's plain route (the composed
   attention), K1-fwd launched once. The cold child starts right after
   phase 4 saves its model and runs beside phases 7 on (its ``nvcc`` is
   host work); after phase 11 its store is copied, the copy's library
   corrupted, and the third child starts beside phases 13 on; phase 27
   runs the warm child alone on the card, then the reference outputs and
   B. The children run with the tuner off (``PADDLE_TPU_TUNE=off``), so
   they key the same steps whatever phases 7-26 decided. Alone (after
   phase 4's model is saved): ``python3 -c "import torch, chip_smoke as cs;
   cs.phase_warm_start(torch, cs.start_fault_child(cs.start_cold_child(
   MODEL_DIR)))"``;
   a child:
   ``python3 chip_smoke.py --warm-start-child MODEL_DIR OUT_DIR``;
11g. phase 28, the C serving ABI (``native/serving_capi.cpp``) and the
   operator CLIs. A: ResNet-50 (``is_test``, 1000 classes, 3 x 224 x 224)
   saved in f32 and in bf16 (a cast of the f32 image, the weights the f32
   draw rounded), served through ``pd_predictor_create`` on the card (ctypes)
   and through the Python ``Predictor`` on the same host images at mb 1 and
   128: the median of 20 calls after the first, the graphs each captured,
   ``utils/flops.py``'s FLOPs and their share of the card's peak, the ABI's
   output byte-equal to the Predictor's; a short buffer gives -2, a bad
   model directory NULL and a message, 4 threads calling together get their
   solo bytes; then 2 calls per dtype and batch with the journal armed under
   ``fluid.profiler``. B (two processes started before phase 26, beside
   phases 26 and 27): ``python -m paddle_tpu_torch.resilience --format
   json`` with the docstring's fault spec, ``--ckpt`` and the black box
   armed, and again with ``--stream``: both exit 0, every fault recovered,
   the preemption resumed, every step completed. C, each CLI's ``main`` in
   this process: ``obs_report`` over A's journal, metrics dump and trace
   (its predictor requests = A's observed ABI calls), ``postmortem`` over
   B's preemption bundle (the injected faults first), ``ckpt_doctor
   verify`` over both runs' trees and ``fuzz`` over a copy of the stream
   run's (4 cases detected), ``timeline`` over A's trace directory, all
   rc 0. Alone (B beside A): ``mkdir -p build; python3 -c "import tempfile,
   torch, chip_smoke as cs; cs.phase_build(); cs.phase_serving_capi(torch,
   tempfile.mkdtemp(dir='build'))"``;
11h. phase 29, dygraph (``paddle_tpu_torch/dygraph/``), under
   ``dygraph.guard()`` on the card. A: one bf16 ``fused_attention`` through
   the tape (``trace_op``) at B128 H12 S128 D64, dropout 0.1, then
   ``reduce_sum`` and ``backward()``: one K1-fwd and one K1-bwd launch, O
   and dQ/dK/dV against ``attention_plain`` / ``attention_bwd_plain`` under
   the op's own seed (its tape salt) at phase 3's bf16 tolerances, and
   dV against the plain backward under the next salt parting by more (a
   wrong salt would fail). B: BERT-base's encoder composed from dygraph
   layers (``tools/dygraph_bert.py``: vocabulary 30522, hidden 768, 12
   layers, 12 heads, FFN 3072), f32, B32 S128, loaded with the startup
   weights of the static ``models.bert.encoder`` program by name: 3
   ``AdamOptimizer`` steps of mean(square(out)) at dropout 0 against the
   same 3 steps of the static program (captured), losses within 1e-4
   relative; then 5 steps at dropout 0.1 (finite losses; K1-fwd 12, K1-bwd
   12 and 25 dropout launches a step; step ms by CUDA events, the median
   of the last four, split into forward, backward and update) and a sixth
   under the profiler (device busy ms, idle share). C: the trained encoder
   in ``eval()`` traced by ``TracedLayer.trace`` at B8, run on the port's
   ``Executor`` (captured) at B8 and B1 three times each, exported by
   ``save_inference_model`` and served by the ``Predictor`` (8 requests,
   12 K1-fwd launches a request after the first), each against the eager
   output within 1e-5. D: ``save_dygraph`` / ``load_dygraph`` of its 149
   arrays byte for byte, and back into the model bit for bit. Alone: ``mkdir
   -p build; python3 -c "import tempfile, torch, chip_smoke as cs;
   cs.phase_build(); cs.phase_dygraph(torch, tempfile.mkdtemp(dir='build'))"``
   (about 30 s after the build);
   phase 30, data parallel over ``torch.distributed``: A, BERT-base bf16
   B128 at dropout 0.1 on one NCCL rank in this process, through
   ``CompiledProgram.with_data_parallel``, captured, its three losses bit
   for bit to the plain executor's, its 158 gradient all-reduces called
   inside the capture, 12 K1-fwd and 12 K1-bwd a step; B, two ranks started
   by the port's launcher sharing the card over gloo (CUDA tensors), 64 rows
   each of a global 128: f32 at dropout 0 against one process's B128 steps
   (``DP_LOSS_RTOL``), then bf16 at dropout 0.1 (the ranks' masks differ,
   their parameters are byte-equal after every step, K1-fwd / K1-bwd /
   dropout 12 / 12 / 25 a step a rank); C, each collective op type on CUDA
   tensors at world 2 against numpy (an op that gloo refuses, by
   ``torch.distributed``'s own refusal, is listed and raises; any other
   error of an op fails the phase); D, ``ReduceStrategy.Reduce`` (each rank half of Adam's
   moments) against B and a ``Checkpointer`` round trip at world 2. Alone:
   ``mkdir -p build; python3 -c "import tempfile, torch, chip_smoke as cs;
   cs.phase_build(); cs.phase_data_parallel(torch,
   tempfile.mkdtemp(dir='build'))"`` (``nccl_probe=True`` adds E: NCCL asked
   for two ranks on one card, its refusal recorded);
12. the kernels line (``multi_tensor_update`` with its five kinds, each
   with its launches; K1-fwd's 64-row tile as ``flash_attn_fwd_q64``),
   then the result line.

Exits non-zero, with no result line, when there is no CUDA card, when the
port's sources are not beside this script, or when any phase fails.
"""
from __future__ import annotations

import atexit
import contextlib
import gc
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# H100 SXM data-sheet peaks (dense): HBM rate, bf16 tensor-core rate, f32 rate
# outside the tensor cores. bound = max(bytes / HBM, FLOPs / peak for the dtype).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# kernel vs plain on the same inputs. f32: both sum in full f32 in another
# order (the JAX suite's own 1e-5, tests/test_pallas_attention.py:34). bf16:
# the kernel rounds the unnormalised probabilities to bf16 where the plain
# version rounds the normalised ones, and both round O to bf16 (2^-8
# relative): the JAX suite's 2e-2 (tests/test_pallas_attention.py:62).
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
# serving path, bf16 end to end over 12 layers, first request. Two gaps are held:
# the kernel against the plain version, both on the card (the kernel rounds P
# before normalising, the plain version after), and the card's plain path
# against the CPU's (cuBLAS and the CPU sum the bf16 matmuls in other orders).
# Each rounding moves an element by about one bf16 ulp, and such moves add up
# over the layers: the limits are 2 ulps of the largest outputs (0.0625 at
# |x| in [8, 16)) for the maximum and 2 ulps of typical outputs (0.0078 at
# |x| in [1, 2)) for the mean.
E2E_MAX_ABS, E2E_MEAN_ABS = 0.125, 1.6e-2
# training kernels vs plain on the same inputs. LSE: f32 sums of exp in another
# order (the bf16 kernel uses the fast __expf): 1e-4 absolute on values ~6.
# Backward, relative to max|ref|: the f32 kernels sum in full f32 in another order
# (1e-5); the bf16 kernels round P*M and dS to bf16 as tensor-core operands where
# the plain version keeps f32, and round the grads once (2^-8 relative): 2e-2, the
# JAX suite's bf16 attention tolerance applied to the largest grad.
LSE_ATOL = 1e-4
BWD_REL = {"float32": 1e-5, "bfloat16": 2e-2}
# Forward with dropout: kept probabilities grow by 1/(1-p), and with causal masking
# the first rows copy single V rows, so outputs reach 4 and beyond, where one bf16
# ulp is 2^-5 > 2e-2. bf16 is held to the larger of ATOL and 1e-2 * max|ref| (a
# little over one ulp of the largest output); f32 to ATOL.
FWD_REL_BF16 = 1e-2
# training path, step 1 from the same weights and the same batch. The loss gap is
# relative to the loss (~11 at initialisation): the two attentions round P to bf16
# at other places (about one bf16 ulp, 2^-8, per element of each layer's output),
# which moves each masked position's cross-entropy by a few 1e-3 with random signs,
# so their mean over 2560 positions moves far less; 1e-2 bounds it with room. The
# update gap is sum|u_a - u_b| / sum|u_b| over every parameter, u the step-1 update:
# Adam's first update is lr * g / |g|, so it differs only where a gradient's sign
# flips, i.e. where |g| is below its bf16 rounding error; 0.1 allows 5% of elements.
TRAIN_LOSS_REL, TRAIN_UPDATE_REL = 1e-2, 0.1
TRAIN_STEPS = 5
ATTN_DROPOUT = 0.1

BERT_REQUESTS = [(8, 128)] * 4 + [(8, 512)] * 2

PEAK_INT8_OPS = 1979e12
# conv1x1_bn against its plain version on the same inputs. y: both accumulate
# the exact products of the rounded operands in f32, in other orders; in bf16 an
# output can then round one ulp apart (2^-7 of |y| at the bottom of a binade):
# held to 2^-7 of max|y|; f32 to 1e-5 of max|y|. The column sums: against torch
# sums of the kernel's own y, only the order of the f32 additions differs (M up
# to 401408 terms: a random-walk error of sqrt(M) * 2^-24 ~ 4e-5 of sum|y|),
# held to 1e-4 of sum|y| per column; against the plain version's sums they also
# carry y's one-ulp moves, held to 2^-7 of sum|y|.
CONV_Y_REL = {"bfloat16": 2 ** -7, "float32": 1e-5}
CONV_STATS_OWN_REL, CONV_STATS_PLAIN_REL = 1e-4, 2 ** -7
# int8 serving, first request. Against the same model with the plain int8 matmul on
# the card: 0 -- the kernel is bit-exact to the plain version and every other op is
# the same deterministic launch. Against the unquantized bf16 model, relative L2 of
# the outputs: each quantized matmul rounds its activations and its weights to
# 1/127 steps of their abs-max (well under 1% rms of each product for Gaussian
# values); 48 of them in sequence, renormalised by the layer norms, stay at a few
# percent. 0.1 bounds that; a codec off by a step everywhere or a wrong scale
# gives O(1). Against the CPU Predictor the same relative L2 limit, not PR 1's bf16
# limits: the card and the CPU round bf16 at other places (PR 1: mean gap 0.008),
# and a bf16 ulp (2^-8 of a value) moves a code by one step (1/127 of the row's
# abs-max) wherever the value lies near a code boundary, so the two int8 runs part
# by about one quantization noise (measured, PR 3's first run: max 0.14, mean 0.021,
# relative L2 2.6%, against 2.8% for int8 vs bf16).
INT8_REL_L2 = 0.1
# the CPU Predictor's reference runs on this many sequences of the first request
# (8 took 17 s of the CPU's integer matmuls; the rows are independent)
INT8_CPU_ROWS = 2
# ResNet-50 training, step 1 from the same weights and batch. The loss gap is
# relative to the loss (~7 at initialisation): bf16 rounds at other places in the
# kernel and cuDNN (one ulp, 2^-8, of scattered elements); 1e-2 as PR 2. The update
# gap is sum|u_a - u_b| / sum|u_b| over every parameter with u = lr * g, the f32
# velocity after step 1 (the bf16 parameters would round most updates away). It is
# held on the f32 build of the same model and weights only: at initialisation this
# model's bf16 gradients are dominated by rounding (on the CPU port at batch 2 the
# bf16 gradient has cosine 0.09 with the f32 one, fused or not), so two bf16
# programs that round at other places give unrelated gradients; they are printed.
# In f32 the sums differ in order only, amplified through the backward by the same
# ill-conditioning: the CPU port's own fused and unfused programs differ by 1.2% at
# batch 2. 0.1 bounds it.
RESNET_LOSS_REL, RESNET_UPDATE_REL = 1e-2, 0.1
RESNET_BATCH, RESNET_STEPS = 128, 5


_T0 = time.perf_counter()


def emit(phase: str, **kw):
    """One JSON line; ``t_s`` is the seconds since the script started."""
    print(json.dumps({"phase": phase, **kw, "t_s": time.perf_counter() - _T0}), flush=True)


def timed_phase(name: str, fn, *args, **kw):
    """Run one phase of ``main`` and print its wall seconds on a line of its
    own (``{"phase_seconds": name, ...}``)."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        print(json.dumps({"phase_seconds": name, "s": round(time.perf_counter() - t0, 3),
                          "t_s": round(time.perf_counter() - _T0, 3)}), flush=True)


def _run(cmd) -> str:
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=60,
                              check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({type(e).__name__})"


def phase_device(torch):
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(smi.splitlines()[0] if smi else "nvidia-smi printed nothing", flush=True)
    from paddle_tpu_torch.core import cuda_build
    nvcc = _run([cuda_build._nvcc(), "--version"]).splitlines()
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc[-1] if nvcc else None, triton=triton_version,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         python=sys.version.split()[0])
    return smi


def phase_build():
    """Every kernel (one ``nvcc`` each), the native slot parser and the C
    serving ABI (``g++`` each), all started together."""
    import threading
    from paddle_tpu_torch import native
    from paddle_tpu_torch.core import cuda_build
    from paddle_tpu_torch.native import capi
    names = list(cuda_build.SOURCES)
    t0 = time.perf_counter()
    hosts = [threading.Thread(target=native.available), threading.Thread(target=capi.build)]
    for t in hosts:
        t.start()
    paths = cuda_build.build(names)
    for t in hosts:
        t.join()
    seconds = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in cuda_build.build_logs.get(n, "").splitlines()
                 if "registers" in ln or "spill" in ln] for n in names}
    emit("build", kernels=names, seconds=seconds,
         libraries=[os.path.relpath(p, REPO) for p in paths.values()], ptxas=ptxas,
         native_parser=os.path.relpath(native.library_path(), REPO),
         native_parser_error=native.build_error,
         serving_capi=os.path.relpath(capi.library_path(), REPO))
    return names


def _device_ms(torch, fn, runs=25, warmup=3):
    """Median device time of ``fn``: each run is timed with CUDA events
    queued behind a busy GPU (torch.cuda._sleep), so the host's launch cost
    is hidden and the events bracket the device work alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _attn_inputs(torch, B, H, S, D, dtype, bias, gen):
    """q/k/v as the model hands them to the op: head-split views of one
    packed [B, S, 3*H*D] projection; bias [B,1,1,S] = -1e4 past each row's
    random valid length."""
    qkv = torch.randn((B, S, 3 * H * D), generator=gen, device="cuda").to(dtype)
    q, k, v = (t.reshape(B, S, H, D).transpose(1, 2) for t in qkv.split(H * D, dim=2))
    b = None
    if bias:
        lens = torch.randint(S // 4, S + 1, (B,), generator=gen, device="cuda")
        valid = torch.arange(S, device="cuda")[None, :] < lens[:, None]
        b = ((valid.float() - 1.0) * 1e4).to(dtype).reshape(B, 1, 1, S)
    return q, k, v, b


def _bound(B, H, S, D, dtype, bias, causal, elsize):
    bytes_moved = 4 * B * H * S * D * elsize + (B * S * elsize if bias else 0)
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)  # score entries computed
    flops = 4 * pairs * D
    t_mem, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def phase_kernels(torch):
    """flash_attn_fwd against attention_plain at the main path's shapes."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.flash_attention import attention_plain, flash_attn_fwd
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = [(8, 12, 128, 64, "bfloat16", True, False),
             (8, 12, 512, 64, "bfloat16", True, False),
             (8, 12, 128, 64, "float32", True, False),
             (8, 12, 512, 64, "float32", True, False),
             (8, 12, 512, 64, "bfloat16", False, True),
             # ragged S (a partial last tile) and the other compiled head width
             (2, 4, 200, 32, "bfloat16", True, True),
             (2, 4, 200, 32, "float32", True, True)]
    results = []
    for B, H, S, D, dt, has_bias, causal in cases:
        dtype = getattr(torch, dt)
        q, k, v, bias = _attn_inputs(torch, B, H, S, D, dtype, has_bias, gen)
        scale = 1.0 / D ** 0.5
        out = flash_attn_fwd(q, k, v, bias, scale, causal)
        again = flash_attn_fwd(q, k, v, bias, scale, causal)
        torch.cuda.synchronize()
        reproducible = torch.equal(out, again)
        del again
        ref = attention_plain(q, k, v, bias, scale, causal)
        err = (out.float() - ref.float()).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        ms = _device_ms(torch, lambda: flash_attn_fwd(q, k, v, bias, scale, causal))
        plain_ms = _device_ms(torch, lambda: attention_plain(q, k, v, bias, scale, causal))
        if causal:
            library_ms = _device_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale))
        else:
            library_ms = _device_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias, scale=scale))
        bound_ms, bound_by = _bound(B, H, S, D, dt, has_bias, causal, q.element_size())
        ok = finite and err <= ATOL[dt] and reproducible
        r = dict(shape=[B, H, S, D], dtype=dt, bias=has_bias, causal=causal,
                 max_abs_err=err, atol=ATOL[dt], bit_reproducible=reproducible, ok=ok, ms=ms,
                 plain_ms=plain_ms, library_ms=library_ms, ratio_to_library=ms / library_ms,
                 bound_ms=bound_ms, bound_by=bound_by)
        emit("kernel_vs_plain", kernel="flash_attn_fwd", **r)
        results.append(r)
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise SystemExit(f"flash_attn_fwd disagrees with attention_plain: {bad}")
    return results


def _train_bound(B, H, S, D, dtype, bias, causal, elsize, backward):
    """Bytes: forward reads Q, K, V and writes O and the LSE; backward reads
    Q, K, V, O, dO and the LSE and writes dQ, dK, dV. FLOPs: 4 B H S^2 D
    forward, 10 B H S^2 D backward (halved for causal); the Philox integer
    work is not counted."""
    tensors = 8 if backward else 4
    bytes_moved = tensors * B * H * S * D * elsize + B * H * S * 4 + (B * S * elsize if bias else 0)
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    flops = (10 if backward else 4) * pairs * D
    t_mem, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def phase_train_kernels(torch):
    """flash_attn_fwd with dropout and the LSE, and flash_attn_bwd, against
    their plain versions, at the training path's shape and the edge cases."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.flash_attention import (attention_bwd_plain, attention_plain,
                                                      bwd_variant, flash_attn_bwd,
                                                      flash_attn_fwd)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    p = ATTN_DROPOUT
    # (B, H, S, D, dtype, bias, causal, dropout); the first is the training path's, the
    # second a microbatch of phase 19's pipeline. The bf16 backward runs its fused
    # variant at S <= 128 and its split one beyond (S 256, 512 and the ragged 200)
    cases = [(128, 12, 128, 64, "bfloat16", True, False, p),
             (PIPE_BATCH // PIPE_MICROBATCHES, 12, 128, 64, "bfloat16", True, False, p),
             (16, 12, 256, 64, "bfloat16", True, False, p),
             (8, 12, 512, 64, "bfloat16", True, False, p),
             (8, 12, 128, 64, "float32", True, False, p),
             (8, 12, 512, 64, "bfloat16", False, True, p),
             (8, 12, 128, 64, "bfloat16", True, False, 0.0),
             (2, 4, 200, 32, "bfloat16", True, True, p),
             (2, 4, 200, 32, "float32", True, True, p)]
    results = []
    for i, (B, H, S, D, dt, has_bias, causal, drop) in enumerate(cases):
        dtype = getattr(torch, dt)
        q, k, v, bias = _attn_inputs(torch, B, H, S, D, dtype, has_bias, gen)
        do = torch.randn((B, H, S, D), generator=gen, device="cuda").to(dtype)
        scale, seed = 1.0 / D ** 0.5, 0x9E3779B97F4A7C15 + i
        o, lse = flash_attn_fwd(q, k, v, bias, scale, causal, drop, seed, return_lse=True)
        dq, dk, dv = flash_attn_bwd(q, k, v, bias, o, lse, do, scale, causal, drop, seed)
        # a second launch on the same inputs gives the same bits (no atomics anywhere)
        o2, lse2 = flash_attn_fwd(q, k, v, bias, scale, causal, drop, seed, return_lse=True)
        grads2 = flash_attn_bwd(q, k, v, bias, o, lse, do, scale, causal, drop, seed)
        torch.cuda.synchronize()
        fwd_same = torch.equal(o, o2) and torch.equal(lse, lse2)
        bwd_same = all(torch.equal(a, b) for a, b in zip((dq, dk, dv), grads2))
        del o2, lse2, grads2
        ref_o = attention_plain(q, k, v, bias, scale, causal, drop, seed)
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        if bias is not None:
            s = s + bias.float()
        if causal:
            s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool, device="cuda").tril(), -1e30)
        ref_lse = torch.logsumexp(s, dim=-1)
        del s
        ref_g = attention_bwd_plain(q, k, v, bias, o, do, scale, causal, drop, seed)
        err = lambda a, r: (a.float() - r.float()).abs().max().item()
        fwd_err, lse_err = err(o, ref_o), err(lse, ref_lse)
        fwd_tol = ATOL[dt]
        if dt == "bfloat16":
            fwd_tol = max(fwd_tol, FWD_REL_BF16 * ref_o.float().abs().max().item())
        bwd = {n: dict(max_abs_err=err(g, r), max_abs_ref=r.float().abs().max().item())
               for n, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref_g)}
        finite = all(bool(torch.isfinite(t).all()) for t in (o, lse, dq, dk, dv))
        del ref_o, ref_lse, ref_g

        fwd_ms = _device_ms(torch, lambda: flash_attn_fwd(q, k, v, bias, scale, causal, drop,
                                                          seed, return_lse=True))
        bwd_ms = _device_ms(torch, lambda: flash_attn_bwd(q, k, v, bias, o, lse, do, scale,
                                                          causal, drop, seed))
        fwd_plain_ms = _device_ms(torch, lambda: attention_plain(q, k, v, bias, scale, causal,
                                                                 drop, seed), runs=5)
        bwd_plain_ms = _device_ms(torch, lambda: attention_bwd_plain(
            q, k, v, bias, o, do, scale, causal, drop, seed), runs=5)
        # yardstick: SDPA forward, and its backward alone (autograd over a kept graph)
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=None if causal else bias, dropout_p=drop,
            is_causal=causal, scale=scale)
        with torch.no_grad():
            fwd_lib_ms = _device_ms(torch, sdpa)
        out_lib = sdpa()
        bwd_lib_ms = _device_ms(torch, lambda: torch.autograd.grad(
            out_lib, (qs, ks, vs), do, retain_graph=True))
        del out_lib, qs, ks, vs

        fb, fby = _train_bound(B, H, S, D, dt, has_bias, causal, q.element_size(), False)
        bb, bby = _train_bound(B, H, S, D, dt, has_bias, causal, q.element_size(), True)
        fwd_ok = finite and fwd_err <= fwd_tol and lse_err <= LSE_ATOL and fwd_same
        bwd_ok = finite and bwd_same and all(r["max_abs_err"] <= BWD_REL[dt] * r["max_abs_ref"]
                                             for r in bwd.values())
        shape = dict(shape=[B, H, S, D], dtype=dt, bias=has_bias, causal=causal, dropout=drop)
        r_fwd = dict(shape, max_abs_err=fwd_err, atol=fwd_tol, lse_max_abs_err=lse_err,
                     lse_atol=LSE_ATOL, bit_reproducible=fwd_same, ok=fwd_ok, ms=fwd_ms,
                     plain_ms=fwd_plain_ms, library_ms=fwd_lib_ms,
                     ratio_to_library=fwd_ms / fwd_lib_ms, bound_ms=fb, bound_by=fby)
        r_bwd = dict(shape, variant=bwd_variant(S, dtype), grads=bwd, rel_tol=BWD_REL[dt],
                     bit_reproducible=bwd_same, ok=bwd_ok,
                     max_abs_err=max(r["max_abs_err"] for r in bwd.values()), ms=bwd_ms,
                     plain_ms=bwd_plain_ms, library_ms=bwd_lib_ms,
                     ratio_to_library=bwd_ms / bwd_lib_ms, bound_ms=bb, bound_by=bby)
        emit("kernel_vs_plain", kernel="flash_attn_fwd+dropout+lse", **r_fwd)
        emit("kernel_vs_plain", kernel="flash_attn_bwd", **r_bwd)
        results.append((r_fwd, r_bwd))
        del q, k, v, bias, do, o, lse, dq, dk, dv
    bad = [r for pair in results for r in pair if not r["ok"]]
    if bad:
        raise SystemExit(f"training kernels disagree with their plain versions: {bad}")
    return results


def _launch_times(torch, fn, calls):
    """Each kernel launch inside one call of ``fn``: torch.profiler's
    key_averages over ``calls`` calls, after one warm call."""
    from torch.profiler import ProfilerActivity
    from paddle_tpu_torch.tools.train_profile import traced
    fn()
    torch.cuda.synchronize()
    with traced([ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    launches = []
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0.0)
        if e.count and dev_us:
            launches.append(dict(kernel=e.key, launches_per_call=e.count / calls,
                                 ms_per_launch=dev_us / e.count / 1e3))
    launches.sort(key=lambda r: -r["ms_per_launch"])
    return launches


def _graph_dot_nodes(torch, fn):
    """The node definitions of a CUDA graph that captures one call of
    ``fn``, read from its DOT dump (``CUDAGraph.debug_dump``; a capture
    records and runs nothing, and a host sync inside ``fn`` makes it raise)."""
    import re
    graph = torch.cuda.CUDAGraph(keep_graph=True)     # keeps the cudaGraph_t to dump
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        fn()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)      # git-ignored
    fd, path = tempfile.mkstemp(suffix=".dot", dir=os.path.join(REPO, "build"))
    os.close(fd)
    try:
        graph.debug_dump(path)
        with open(path) as f:
            text = f.read()
    finally:
        os.remove(path)
    del graph
    # one chunk per node definition ('"graph_1_node_0"[... label="..."]'); an
    # edge line ('"a" -> "b"') opens none
    nodes = re.split(r'^\s*"?[^"\s\[]*node[^"\s\[]*"?\s*\[', text, flags=re.M)[1:]
    if not nodes:
        raise SystemExit(f"a captured graph's DOT dump names no node: {text[:400]!r}")
    return nodes


def _graph_launches(torch, fn, names):
    """The kernel launches of one call of ``fn`` by each of ``names``: the
    kernel nodes of a CUDA graph that captures the call (``_graph_dot_nodes``).
    Exact, where a profiler trace may lose its first records (ROADMAP 3.2)."""
    nodes = _graph_dot_nodes(torch, fn)
    return {n: sum(n in node for node in nodes) for n in names}


def _breakdown(call, shape, launches):
    return dict(call=call, shape=shape,
                launches_per_call=sum(x["launches_per_call"] for x in launches),
                device_ms_per_call=sum(x["ms_per_launch"] * x["launches_per_call"]
                                       for x in launches) or None,
                kernels=launches or "not measured: the profiler recorded no device time")


def phase_launch_breakdown(torch, calls=20):
    """The device time of each kernel launch inside one flash_attn_fwd and one
    flash_attn_bwd call (torch.profiler's key_averages over ``calls`` calls),
    at the main paths' shapes and at S 512, where the backward is split."""
    from paddle_tpu_torch.ops.flash_attention import bwd_variant, flash_attn_bwd, flash_attn_fwd
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    dt = torch.bfloat16
    results = []
    # (B, S, dropout, what): serving's forward; training's forward (with the LSE) and
    # backward, with dropout and without (the difference is the Philox work); the split
    # backward
    p = ATTN_DROPOUT
    for B, S, drop, what in ((8, 512, 0.0, "fwd"), (128, 128, p, "fwd+lse"),
                             (128, 128, 0.0, "fwd+lse"), (128, 128, p, "bwd"),
                             (128, 128, 0.0, "bwd"), (8, 512, p, "bwd")):
        q, k, v, bias = _attn_inputs(torch, B, 12, S, 64, dt, True, gen)
        scale, seed = 0.125, 0x5EED + S
        if what != "bwd":
            lse_wanted = what == "fwd+lse"
            fn = lambda: flash_attn_fwd(q, k, v, bias, scale, False, drop, seed,
                                        return_lse=lse_wanted)
        else:
            o, lse = flash_attn_fwd(q, k, v, bias, scale, False, drop, seed, return_lse=True)
            do = torch.randn(o.shape, generator=gen, device="cuda").to(dt)
            fn = lambda: flash_attn_bwd(q, k, v, bias, o, lse, do, scale, False, drop, seed)
        launches = _launch_times(torch, fn, calls)
        r = dict(_breakdown(f"flash_attn_{what}", [B, 12, S, 64], launches), dtype="bfloat16",
                 bias=True, dropout=drop, variant=bwd_variant(S, dt) if what == "bwd" else None)
        emit("launch_breakdown", **r)
        results.append(r)
        del q, k, v, bias, fn
    return results


def _hidden_dropout_off(program):
    """Turn the `dropout` ops (hidden dropout) and their grad ops to inference
    mode, in every block (a recompute segment's too); fused_attention keeps
    its in-kernel dropout."""
    for op in (op for blk in program.blocks for op in blk.ops):
        if op.type in ("dropout", "dropout_grad"):
            op.attrs["is_test"] = True
            if "__fwd_attrs__" in op.attrs:
                op.attrs["__fwd_attrs__"] = dict(op.attrs["__fwd_attrs__"], is_test=True)


def _step_once(torch, pt, program, total, params, init, feed, device):
    """One step from ``init`` (name -> tensor) on ``device``: (loss, name ->
    f32 update of each parameter)."""
    program._rng_run_counter = 0             # the same dropout masks on every device
    scope = pt.Scope()
    for n, t in init.items():
        scope.set_var(n, t.to(device, copy=True))
    with pt.scope_guard(scope):
        loss = pt.Executor(pt.CPUPlace() if device == "cpu" else None).run(
            program, feed=feed, fetch_list=[total])[0]
    ups = {n: (scope.find_var(n).float() - init[n].to(device).float()).cpu() for n in params}
    return float(np.asarray(loss).reshape(-1)[0]), ups


def _gaps(a, b):
    (la, ua), (lb, ub) = a, b
    num = sum(float((ua[n] - ub[n]).abs().sum()) for n in ub)
    den = sum(float(ub[n].abs().sum()) for n in ub)
    return dict(loss_a=la, loss_b=lb, loss_rel_gap=abs(la - lb) / abs(lb),
                update_rel_l1_gap=num / den)


def _update_gap(init, a, b):
    """sum |(a - init) - (b - init)| / sum |b - init| over the float state."""
    num = den = 0.0
    for n, t0 in init.items():
        if t0.is_floating_point():
            ua, ub = a[n].float() - t0.float(), b[n].float() - t0.float()
            num += float((ua - ub).abs().sum())
            den += float(ub.abs().sum())
    return num / den


def _train_both_paths(torch, pt, main, feed, loss, init, steps, counters):
    """``steps`` steps from ``init`` on the executor's path, then on the eager
    reference path (``_reuse_forward = _group_updates = False``), then on the
    reference path again, each in a scope of its own with the same dropout
    counter; the first two then take 3 more steps under the profiler. Per
    path: losses, step ms, peak device memory, the launches of each counter
    in wrapper ``counters``, and the breakdown. Across paths: which state
    differs after step 1 and the gaps after ``steps`` steps, executor against
    reference beside reference against itself (the card's run-to-run
    noise)."""
    from paddle_tpu_torch.tools.train_profile import profile_steps
    out, states = {}, {}
    for path in ("executor", "reference", "reference_again"):
        scope = pt.Scope()
        for n, t in init.items():
            scope.set_var(n, t.clone())
        exe = pt.Executor()
        exe._use_graphs = False              # both eager (graphs: phase_captured_training)
        if path != "executor":
            exe._reuse_forward = exe._group_updates = False
        main._rng_run_counter = 0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters:
            fn.launches = 0
        losses, step_s = [], []
        with pt.scope_guard(scope):
            for i in range(steps):
                t0 = time.perf_counter()
                losses.append(float(exe.run(main, feed=feed, fetch_list=[loss])[0][0]))
                step_s.append(time.perf_counter() - t0)
                if i == 0:
                    states[path, 1] = {n: scope.find_var(n).clone() for n in init}
            launches = {fn.__name__: fn.launches for fn in counters}
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            states[path, steps] = {n: scope.find_var(n).clone() for n in init}
            prof = None if path == "reference_again" else \
                profile_steps(torch, exe, main, feed, loss, PROFILED_STEPS)
        del scope, exe
        warm = sorted(step_s[1:])
        out[path] = dict(losses=losses, step_ms=[t * 1e3 for t in step_s],
                         step_ms_median_warm=warm[len(warm) // 2] * 1e3, peak_memory_gb=peak_gb,
                         launches=launches,
                         launches_per_step={k: v / steps for k, v in launches.items()})
        if prof is not None:
            out[path]["profile"] = dict(prof, top=prof["top"][:8])
    across = {}
    for a, b in (("executor", "reference"), ("reference_again", "reference")):
        s1a, s1b = states[a, 1], states[b, 1]
        differ = [n for n in init if not torch.equal(s1a[n], s1b[n])]
        la, lb = out[a]["losses"], out[b]["losses"]
        across[f"{a}_vs_{b}"] = dict(
            step1_loss_equal=la[0] == lb[0], step1_state_differs=len(differ),
            step1_state_differs_first=differ[:8],
            loss_rel_gap=max(abs(x - y) / abs(y) for x, y in zip(la, lb)),
            update_rel_l1_gap=_update_gap(init, states[a, steps], states[b, steps]))
    del states
    torch.cuda.empty_cache()
    return out, across


def phase_train_path(torch):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import flash_attention, multi_tensor
    from paddle_tpu_torch.tools.train_profile import (BATCH, LR, MASKS_PER_SEQ, SEQ,
                                                      build_pretrain, pretrain_feed)
    cfg = bert.BertConfig(dtype="bfloat16", dropout=ATTN_DROPOUT)
    t0 = time.perf_counter()
    main, startup, total, pg = build_pretrain(cfg, BATCH, SEQ, MASKS_PER_SEQ, LR, SEED)
    build_s = time.perf_counter() - t0
    params = [p.name for p, _ in pg]
    feed = pretrain_feed(np.random.RandomState(SEED), cfg, BATCH, SEQ, MASKS_PER_SEQ)
    scope = pt.Scope()
    exe = pt.Executor()                      # the card
    with pt.scope_guard(scope):
        t0 = time.perf_counter()
        exe.run(startup)
        torch.cuda.synchronize()
        startup_s = time.perf_counter() - t0
        state = [n for n, v in main.global_block().vars.items() if v.persistable]
        init = {n: scope.find_var(n).clone() for n in state}
        n_params = sum(scope.find_var(n).numel() for n in params)
    del scope
    counters = (flash_attention.flash_attn_fwd, flash_attention.flash_attn_bwd,
                multi_tensor.multi_tensor_update)
    paths, across = _train_both_paths(torch, pt, main, feed, total, init, TRAIN_STEPS, counters)
    expected = {"executor": {"flash_attn_fwd": cfg.n_layers * TRAIN_STEPS,
                             "flash_attn_bwd": cfg.n_layers * TRAIN_STEPS,
                             "multi_tensor_update": TRAIN_STEPS},
                "reference": {"flash_attn_fwd": 2 * cfg.n_layers * TRAIN_STEPS,
                              "flash_attn_bwd": cfg.n_layers * TRAIN_STEPS,
                              "multi_tensor_update": 0}}
    new = paths["executor"]
    model = (f"bert-base pretrain L{cfg.n_layers} H{cfg.hidden} A{cfg.n_heads} "
             f"FFN{cfg.ffn_hidden} vocab{cfg.vocab_size} {cfg.dtype} B{BATCH} S{SEQ} "
             f"masks {BATCH * MASKS_PER_SEQ} dropout {cfg.dropout} Adam({LR})")
    emit("train_path", model=model, params=n_params, build_s=build_s, startup_s=startup_s,
         adam_ops=sum(op.type == "adam" for op in main.global_block().ops),
         paths=paths, expected_launches=expected, across_paths=across,
         loss_rel_limit=TRAIN_LOSS_REL, update_rel_l1_limit=TRAIN_UPDATE_REL,
         sequences_per_s=BATCH / (new["step_ms_median_warm"] / 1e3))
    for path, want in expected.items():
        if paths[path]["launches"] != want:
            raise SystemExit(f"training launches on the {path} path {paths[path]['launches']}, "
                             f"expected {want}")
    losses = new["losses"]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise SystemExit(f"training loss is not finite and falling: {losses}")
    g = across["executor_vs_reference"]
    if not (g["step1_loss_equal"] and g["loss_rel_gap"] <= TRAIN_LOSS_REL
            and g["update_rel_l1_gap"] <= TRAIN_UPDATE_REL):
        raise SystemExit(f"training: the executor's path and the eager reference path "
                         f"part: {g}")
    launches, step_ms = new["launches"], new["step_ms_median_warm"]

    # step 1 against the card's composed attention (dropout 0 on both: the
    # composed program's dropout ops draw other masks than the kernels)
    cfg0 = bert.BertConfig(dtype="bfloat16", dropout=0.0)
    runs = {}
    for impl in ("auto", "composed"):
        cfg0.attn_impl = impl
        prog, _, tot, pg0 = build_pretrain(cfg0, BATCH, SEQ, MASKS_PER_SEQ, LR, SEED)
        assert [p.name for p, _ in pg0] == params
        runs[impl] = _step_once(torch, pt, prog, tot, params, init, feed, "cuda")
        del prog
    composed = _gaps(runs["auto"], runs["composed"])
    del runs
    torch.cuda.empty_cache()

    # step 1 at batch 2 against the CPU port: the same weights, the same
    # attention-dropout masks (Philox on both), hidden dropout off on both
    B2 = 2
    prog, _, tot, _ = build_pretrain(cfg, B2, SEQ, MASKS_PER_SEQ, LR, SEED)
    _hidden_dropout_off(prog)
    feed2 = pretrain_feed(np.random.RandomState(SEED + 1), cfg, B2, SEQ, MASKS_PER_SEQ)
    init_cpu = {n: t.cpu() for n, t in init.items()}
    t0 = time.perf_counter()
    cpu_run = _step_once(torch, pt, prog, tot, params, init_cpu, feed2, "cpu")
    cpu_s = time.perf_counter() - t0
    flash_attention.flash_attn_fwd.launches = 0
    card_run = _step_once(torch, pt, prog, tot, params, init, feed2, "cuda")
    if flash_attention.flash_attn_fwd.launches != cfg.n_layers:
        raise SystemExit("the batch-2 card step did not run the attention kernels")
    cpu = dict(_gaps(card_run, cpu_run), cpu_seconds=cpu_s)
    emit("train_step1_gaps", vs_card_composed=composed, vs_cpu_port_batch2=cpu,
         loss_rel_limit=TRAIN_LOSS_REL, update_rel_l1_limit=TRAIN_UPDATE_REL)
    for name, g in (("card composed", composed), ("CPU port", cpu)):
        if not (g["loss_rel_gap"] <= TRAIN_LOSS_REL
                and g["update_rel_l1_gap"] <= TRAIN_UPDATE_REL):
            raise SystemExit(f"training step 1 against the {name}: gaps {g} exceed the limits")
    return launches, step_ms, paths


def _conv_bound(M, K, N, elsize, prologue):
    """Bytes: x, w and y once, the statistics (and the prologue's four [K]
    vectors); operations: 2 M K N at the dtype's peak."""
    bytes_moved = (M * K + K * N + M * N) * elsize + 2 * N * 4 + (4 * K * 4 if prologue else 0)
    flops = 2 * M * K * N
    peak = PEAK_FLOPS["bfloat16"] if elsize == 2 else PEAK_FLOPS["float32"]
    t_mem, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / peak
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def resnet_fused_shapes(program, batch):
    """(M, K, N) -> count of the program's conv2d_bn_fused ops at ``batch``."""
    blk = program.global_block()
    shapes = {}
    for op in blk.ops:
        if op.type == "conv2d_bn_fused":
            x = blk.var(op.input("Input")[0])
            w = blk.var(op.input("Filter")[0])
            _, H, W, C = x.shape
            key = (batch * H * W, C, w.shape[0])
            shapes[key] = shapes.get(key, 0) + 1
    return shapes


def phase_conv_bn_kernels(torch, shapes):
    """fused_conv1x1_bn_fwd against conv1x1_bn_plain at ResNet-50's fused
    shapes (bf16, no prologue, as conv2d_bn_fused calls it), with the
    prologue, and at ragged shapes (the unaligned load path, f32)."""
    from paddle_tpu_torch.ops.conv_bn import conv1x1_bn_plain, fused_conv1x1_bn_fwd
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    cases = [(M, K, N, "bfloat16", False, False, n) for (M, K, N), n in sorted(shapes.items())]
    cases += [(100352, 512, 128, "bfloat16", True, True, 0),
              (1000, 36, 100, "bfloat16", True, True, 0),
              (1000, 72, 100, "float32", True, True, 0),
              # a ragged last M tile under 16 column blocks at K 2048
              (1000, 2048, 2048, "bfloat16", False, False, 0)]
    results = []
    for M, K, N, dt, apply_in_bn, relu_in, count in cases:
        dtype = getattr(torch, dt)
        x2 = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
        # the op hands the kernel the transposed view of the [N, K] filter
        w = (torch.randn((N, K), generator=gen, device="cuda") * K ** -0.5).to(dtype).t()
        mu, g, b = (torch.randn((K,), generator=gen, device="cuda") for _ in range(3))
        var = torch.rand((K,), generator=gen, device="cuda") + 0.5
        args = (x2, w, mu, var, g, b, 1e-5, relu_in, apply_in_bn)
        y, s, ss = fused_conv1x1_bn_fwd(*args)
        again = fused_conv1x1_bn_fwd(*args)      # the same bits: a fixed order, no atomics
        torch.cuda.synchronize()
        reproducible = all(torch.equal(a, b) for a, b in zip((y, s, ss), again))
        del again
        yp, sp, ssp = conv1x1_bn_plain(*args)
        yk, ypf = y.float(), yp.float()
        err = (yk - ypf).abs().max().item()
        y_tol = CONV_Y_REL[dt] * ypf.abs().max().item()
        mag, mag2 = yk.abs().sum(0), (yk * yk).sum(0)
        own = max(((s - yk.sum(0)).abs() / mag).max().item(),
                  ((ss - (yk * yk).sum(0)).abs() / mag2).max().item())
        plain = max(((s - sp).abs() / mag).max().item(), ((ss - ssp).abs() / mag2).max().item())
        finite = all(bool(torch.isfinite(t).all()) for t in (y, s, ss))
        del yk, ypf, yp, sp, ssp, mag, mag2
        ms = _device_ms(torch, lambda: fused_conv1x1_bn_fwd(*args))
        plain_ms = _device_ms(torch, lambda: conv1x1_bn_plain(*args), runs=5)
        wc = w.contiguous()
        matmul_ms = _device_ms(torch, lambda: torch.matmul(x2, wc))
        bound_ms, bound_by = _conv_bound(M, K, N, x2.element_size(), apply_in_bn)
        ok = (finite and reproducible and err <= y_tol and own <= CONV_STATS_OWN_REL
              and plain <= CONV_STATS_PLAIN_REL)
        r = dict(shape=[M, K, N], dtype=dt, apply_in_bn=apply_in_bn, relu_in=relu_in,
                 launches_per_forward_pass=count, max_abs_err=err, atol=y_tol,
                 stats_vs_own_y_rel=own, stats_vs_plain_rel=plain, bit_reproducible=reproducible,
                 ok=ok, ms=ms, plain_ms=plain_ms, matmul_ms=matmul_ms,
                 ratio_to_matmul=ms / matmul_ms, library_ms=None,
                 bound_ms=bound_ms, bound_by=bound_by)
        emit("kernel_vs_plain", kernel="fused_conv1x1_bn_fwd", **r)
        results.append(r)
        del x2, w, wc, y, s, ss
    torch.cuda.empty_cache()
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise SystemExit(f"fused_conv1x1_bn_fwd disagrees with conv1x1_bn_plain: {bad}")
    path = [r for r in results if r["launches_per_forward_pass"]]
    total = {k: sum(r[k] * r["launches_per_forward_pass"] for r in path)
             for k in ("ms", "bound_ms", "matmul_ms")}
    emit("conv1x1_bn_forward_pass", launches=sum(r["launches_per_forward_pass"] for r in path),
         **total, ratio_to_matmul=total["ms"] / total["matmul_ms"])
    return results


def _int8_bound(M, K, N, elsize):
    bytes_moved = M * K * elsize + K * N + N * 4 + M * N * elsize
    t_mem, t_ops = bytes_moved / HBM_BYTES_PER_S, 2 * M * K * N / PEAK_INT8_OPS
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def phase_int8_kernels(torch):
    """int8_matmul against int8_matmul_plain, bit for bit: the serving
    path's shapes (qkv, out, ffn1, ffn2 at 8 x 128 and 8 x 512 tokens), a
    ragged shape (the unaligned load paths) and f32 activations."""
    from paddle_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 4)
    fcs = [(768, 2304), (768, 768), (768, 3072), (3072, 768)]
    cases = [(M, K, N, "bfloat16") for M in (1024, 4096) for K, N in fcs]
    # ragged: unaligned rows and N (the byte-copy paths); one and eight rows; a K that
    # is not a multiple of the 64-deep K stage (codes padded to 208); f32 activations
    cases += [(1001, 301, 131, "bfloat16"), (1, 768, 768, "bfloat16"), (8, 768, 768, "bfloat16"),
              (300, 200, 256, "bfloat16"), (1024, 768, 768, "float32")]
    results = []
    for M, K, N, dt in cases:
        dtype = getattr(torch, dt)
        x2 = (torch.randn((M, K), generator=gen, device="cuda") * 3).to(dtype)
        w8 = torch.randint(-127, 128, (K, N), generator=gen, device="cuda").to(torch.int8)
        ws = torch.rand((N,), generator=gen, device="cuda") * 1e-3
        out, xs, xq = int8_matmul(x2, w8, ws, return_codes=True)
        again = int8_matmul(x2, w8, ws)
        torch.cuda.synchronize()
        reproducible = torch.equal(out, again)
        del again
        ref, rxs, rxq = int8_matmul_plain(x2, w8, ws, return_codes=True)
        err = (out.float() - ref.float()).abs().max().item()
        exact = (torch.equal(out, ref) and torch.equal(xs, rxs) and torch.equal(xq, rxq))
        finite = bool(torch.isfinite(out).all())
        del ref, rxs, rxq, xs, xq
        ms = _device_ms(torch, lambda: int8_matmul(x2, w8, ws))
        plain_ms = _device_ms(torch, lambda: int8_matmul_plain(x2, w8, ws), runs=5)
        wb = (w8.float() * ws).to(dtype)
        matmul_ms = _device_ms(torch, lambda: torch.matmul(x2, wb))
        bound_ms, bound_by = _int8_bound(M, K, N, x2.element_size())
        r = dict(shape=[M, K, N], dtype=dt, max_abs_err=err, atol=0.0, bit_exact=exact,
                 bit_reproducible=reproducible, ok=exact and finite and reproducible, ms=ms,
                 plain_ms=plain_ms, matmul_ms=matmul_ms, ratio_to_matmul=ms / matmul_ms,
                 library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
        emit("kernel_vs_plain", kernel="int8_matmul", **r)
        results.append(r)
        del x2, w8, ws, wb, out
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise SystemExit(f"int8_matmul is not bit-exact to int8_matmul_plain: {bad}")
    for M in (1024, 4096):
        rows = [r for r in results if r["shape"][0] == M and r["dtype"] == "bfloat16"]
        total = {k: 12 * sum(r[k] for r in rows) for k in ("ms", "bound_ms", "matmul_ms")}
        emit("int8_matmul_per_request", tokens=M, launches=12 * len(rows), **total,
             ratio_to_matmul=total["ms"] / total["matmul_ms"])
    return results


def phase_gemm_launch_breakdown(torch, calls=20):
    """The device time of each kernel launch inside one fused_conv1x1_bn_fwd
    call (the product and the column sums; ResNet-50's M 401408 at N 256 and
    N 64) and one int8_matmul call (the quantize pass and the product; N 3072
    at M 1024 and 4096), bf16, as the main paths call them."""
    from paddle_tpu_torch.ops.conv_bn import fused_conv1x1_bn_fwd
    from paddle_tpu_torch.ops.int8_matmul import int8_matmul
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 6)
    results = []
    for M, K, N in ((401408, 64, 256), (401408, 256, 64)):
        x2 = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn((N, K), generator=gen, device="cuda") * K ** -0.5).to(torch.bfloat16).t()
        z, one = torch.zeros(K, device="cuda"), torch.ones(K, device="cuda")
        launches = _launch_times(torch, lambda: fused_conv1x1_bn_fwd(
            x2, w, z, one, z, z, 1e-5, False, False), calls)
        results.append(dict(_breakdown("fused_conv1x1_bn_fwd", [M, K, N], launches),
                            dtype="bfloat16"))
        del x2, w
    for M, K, N in ((1024, 768, 3072), (4096, 768, 3072)):
        x2 = (torch.randn((M, K), generator=gen, device="cuda") * 3).to(torch.bfloat16)
        w8 = torch.randint(-127, 128, (K, N), generator=gen, device="cuda").to(torch.int8)
        ws = torch.rand((N,), generator=gen, device="cuda") * 1e-3
        launches = _launch_times(torch, lambda: int8_matmul(x2, w8, ws), calls)
        results.append(dict(_breakdown("int8_matmul", [M, K, N], launches), dtype="bfloat16"))
        del x2, w8, ws
    for r in results:
        emit("launch_breakdown", **r)
    return results


def _serve(torch, pred, requests):
    outs, lat = [], []
    for feed in requests:
        t0 = time.perf_counter()
        outs.append(pred.run(feed)[0])
        lat.append(time.perf_counter() - t0)
    return outs, lat


def _max_ulp(torch, a, b) -> int:
    """The largest distance of two float tensors of one dtype in units in the
    last place (their bit patterns read as sign-magnitude integers)."""
    it = torch.int32 if a.element_size() == 4 else torch.int16
    top = 1 << (8 * a.element_size() - 1)
    ia, ib = (t.contiguous().view(it).long() for t in (a, b))
    ia, ib = (torch.where(t < 0, -(t + top), t) for t in (ia, ib))
    return int((ia - ib).abs().max()) if ia.numel() else 0


def _graphs_held(pred):
    """The graphs a Predictor captured: signature, device memory its pool
    holds, kernel launches a replay adds."""
    return [dict(signature=[list(x) if isinstance(x, tuple) else x for x in sig],
                 memory_gb=exe.memory_bytes / 1e9,
                 launches_per_replay={fn.__name__: n for fn, n in exe.launches.items()})
            for sig, exe in pred._compiled.items()]


def phase_serving_modes(torch, label, model_dir, pred, requests, outs, lat, counter,
                        kernel_name):
    """Graph against eager serving on the same requests, in this call: the
    eager run of the same model (``_use_graphs = False``) must give the same
    bits; wall ms of each request, the profiler's idle share at each shape,
    the graphs captured with their memory, and one replay's kernels (from
    the profiler) against the launches its counters add."""
    from paddle_tpu_torch.core import cuda_build
    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.tools.serving_profile import profile_shape
    from paddle_tpu_torch.tools.train_profile import traced
    from torch.profiler import ProfilerActivity
    eager = Predictor(model_dir)
    eager._use_graphs = False
    for feed in requests:                       # first use of each shape
        eager.run(feed)
    torch.cuda.synchronize()
    eager_outs, eager_lat = _serve(torch, eager, requests)
    same = [bool(np.array_equal(a, b)) for a, b in zip(outs, eager_outs)]
    by_shape = {}
    for (B, S), feed in zip(BERT_REQUESTS, requests):
        if (B, S) in by_shape:
            continue
        by_shape[(B, S)] = {"graph": profile_shape(torch, pred, feed, 3),
                            "eager": profile_shape(torch, eager, feed, 3)}
        # the profiler slows the host; against the unprofiled wall time of
        # the same shape above, the same device busy time gives the idle share
        for mode, times in (("graph", lat), ("eager", eager_lat)):
            r = by_shape[(B, S)][mode]
            r.pop("top")
            wall = statistics.median(t for (b, s_), t in zip(BERT_REQUESTS, times)
                                     if (b, s_) == (B, S)) * 1e3
            r["unprofiled_wall_ms"] = wall
            r["unprofiled_idle_share"] = max(0.0, 1 - r["device_busy_ms"] / wall)
    before = {fn: fn.launches for fn in cuda_build.COUNTED}
    with traced([ProfilerActivity.CUDA]) as prof:
        pred.run(requests[0])
        torch.cuda.synchronize()
    counted = {fn.__name__: fn.launches - n for fn, n in before.items() if fn.launches != n}
    n_traced = sum(e.count for e in prof.key_averages() if kernel_name in e.key)
    replay = dict(counters=counted, profiler_kernels={kernel_name: n_traced})
    del eager
    r = dict(requests=[dict(batch=B, seq=S, graph_ms=a * 1e3, eager_ms=b * 1e3)
                       for (B, S), a, b in zip(BERT_REQUESTS, lat, eager_lat)],
             bit_equal_to_eager=same,
             profile={f"{B}x{S}": v for (B, S), v in by_shape.items()},
             graphs=_graphs_held(pred), one_replay=replay)
    emit(f"{label}_graph_vs_eager", **r)
    if not all(same):
        raise SystemExit(f"{label}: graph-replayed outputs differ from the eager run: {same}")
    if n_traced != counted.get(counter):
        raise SystemExit(f"{label}: one replay ran {n_traced} {kernel_name} kernels (profiler) "
                         f"but its counters add {counted}")
    return r


def phase_int8_path(torch, workdir):
    """The int8 serving path (phase 7)."""
    from paddle_tpu_torch.contrib import quantize
    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import flash_attention, int8_matmul as i8
    from paddle_tpu_torch.tools.serving_profile import bert_feed, save_bert_encoder

    cfg = bert.BertConfig(dtype="bfloat16")
    bf16_dir, int8_dir = os.path.join(workdir, "bert_bf16"), os.path.join(workdir, "bert_int8")
    t0 = time.perf_counter()
    save_bert_encoder(bf16_dir, cfg, SEED, int8_dir=int8_dir)   # startup on the card
    build_s = time.perf_counter() - t0
    pred = Predictor(int8_dir)
    ops = [op.type for op in pred.program.global_block().ops]
    n_qmul = ops.count("quantized_mul")
    int8_vars = sorted(n for n, v in pred._state.items() if v.dtype == torch.int8)

    rng = np.random.RandomState(SEED)
    requests = [bert_feed(rng, B, S, cfg.vocab_size) for B, S in BERT_REQUESTS]
    warm_rng = np.random.RandomState(SEED + 1)
    ref_pred = Predictor(bf16_dir)
    for p in (pred, ref_pred):
        for B, S in sorted(set(BERT_REQUESTS)):
            p.run(bert_feed(warm_rng, B, S, cfg.vocab_size))
    torch.cuda.synchronize()

    i8.int8_matmul.launches = 0
    flash_attention.flash_attn_fwd.launches = 0
    outs, lat = _serve(torch, pred, requests)
    launches = {"int8_matmul": i8.int8_matmul.launches,
                "flash_attn_fwd": flash_attention.flash_attn_fwd.launches}
    expected = {"int8_matmul": n_qmul * len(requests),
                "flash_attn_fwd": cfg.n_layers * len(requests)}
    bf16_outs, bf16_lat = _serve(torch, ref_pred, requests)
    for (B, S), o in zip(BERT_REQUESTS, outs):
        if o.shape != (B, S, cfg.hidden) or not np.isfinite(o).all():
            raise SystemExit(f"bad int8 output {o.shape} finite={np.isfinite(o).all()}")
    if n_qmul != 4 * cfg.n_layers or launches != expected:
        raise SystemExit(f"int8 serving: {n_qmul} quantized_mul ops, launches {launches}, "
                         f"expected {expected}")
    modes = phase_serving_modes(torch, "int8_serving", int8_dir, pred, requests, outs, lat,
                                "int8_matmul", "int8_gemm_kernel")

    # references for the first request
    kernel = quantize.int8_matmul
    quantize.int8_matmul = i8.int8_matmul_plain     # the op's matmul, on the plain version
    try:
        plain_out = Predictor(int8_dir).run(requests[0])[0]
    finally:
        quantize.int8_matmul = kernel
    # the CPU's integer matmuls take seconds a sequence: its first INT8_CPU_ROWS
    # sequences (each row's codes and scales are its own)
    t0 = time.perf_counter()
    cpu_out = Predictor(int8_dir, device="cpu").run(
        {k: v[:INT8_CPU_ROWS] for k, v in requests[0].items()})[0]
    cpu_s = time.perf_counter() - t0
    gaps = {}
    for name, a, b in (("kernel_vs_card_plain", outs[0], plain_out),
                       ("card_vs_cpu_plain", outs[0][:INT8_CPU_ROWS], cpu_out),
                       ("int8_vs_bf16", outs[0], bf16_outs[0])):
        d = np.abs(a - b)
        gaps[name] = dict(max_abs=float(d.max()), mean_abs=float(d.mean()),
                          rel_l2=float(np.linalg.norm(a - b) / np.linalg.norm(b)))
    per_req = [dict(batch=B, seq=S, ms=s * 1e3, tokens_per_s=B * S / s, bf16_ms=t * 1e3)
               for (B, S), s, t in zip(BERT_REQUESTS, lat, bf16_lat)]
    emit("int8_path", model=f"bert encoder L{cfg.n_layers} H{cfg.hidden} int8 weights "
                            f"(quantize_weights int8_compute=True), bf16 activations",
         quantized_mul_ops=n_qmul, int8_vars=len(int8_vars), build_startup_save_s=build_s,
         requests=per_req, launches=launches, expected_launches=expected,
         first_request_gaps=gaps, rel_l2_limit=INT8_REL_L2, mean_abs_output=float(np.abs(bf16_outs[0]).mean()),
         cpu_seconds=cpu_s)
    g = gaps["kernel_vs_card_plain"]
    if g["max_abs"] != 0.0:
        raise SystemExit(f"int8 path: the kernel's output differs from the plain int8 "
                         f"matmul's on the card: {g}")
    for name in ("card_vs_cpu_plain", "int8_vs_bf16"):
        if not gaps[name]["rel_l2"] <= INT8_REL_L2:
            raise SystemExit(f"int8 path: {name} gap {gaps[name]} exceeds rel L2 {INT8_REL_L2}")
    return launches, modes


def _resnet_feed(torch, rng, batch, device):
    from paddle_tpu_torch.tools.train_profile import resnet_feed
    raw = resnet_feed(rng, batch)
    return {"img": torch.from_numpy(raw["img"]).to(device, torch.bfloat16),
            "label": torch.from_numpy(raw["label"]).to(device)}


def _resnet_step1(torch, pt, program, loss, init, feed, device):
    """One step from ``init``: (loss, velocity name -> f32 tensor on the CPU).
    Momentum's first velocity is the gradient, so lr * v is the f32 update."""
    scope = pt.Scope()
    for n, t in init.items():
        scope.set_var(n, t.to(device, copy=True))
    with pt.scope_guard(scope):
        value = pt.Executor(pt.CPUPlace() if device == "cpu" else None).run(
            program, feed=feed, fetch_list=[loss])[0]
    vel = {n: scope.find_var(n).float().cpu() for n in init if n.endswith("_velocity_0")}
    return float(value[0]), vel


def _resnet_gaps(a, b):
    (la, va), (lb, vb) = a, b
    num = sum(float((va[n] - vb[n]).abs().sum()) for n in vb)
    den = sum(float(vb[n].abs().sum()) for n in vb)
    return dict(loss_a=la, loss_b=lb, loss_rel_gap=abs(la - lb) / abs(lb),
                update_rel_l1_gap=num / den)


def phase_resnet_train(torch, main_prog, startup, loss, params_grads, fused):
    """The ResNet-50 training path (phase 8)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import conv_bn, multi_tensor
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.tools.train_profile import (LR, MASKS_PER_SEQ, NMT_SEQ, SEQ,
                                                      build_deepfm, build_mnist, build_pretrain,
                                                      build_resnet50, build_transformer,
                                                      transformer_config)
    ops = [op.type for op in main_prog.global_block().ops]
    per_step = ops.count("conv2d_bn_fused")
    if fused != 33 or per_step != 33 or ops.count("conv2d_bn_fused_grad") != 33:
        raise SystemExit(f"fuse pass: {fused} chains, {per_step} fused ops; expected 33")
    feed = _resnet_feed(torch, np.random.RandomState(SEED), RESNET_BATCH, "cuda")
    scope = pt.Scope()
    with pt.scope_guard(scope):
        t0 = time.perf_counter()
        pt.Executor().run(startup)
        torch.cuda.synchronize()
        startup_s = time.perf_counter() - t0
        state = [n for n, v in main_prog.global_block().vars.items() if v.persistable]
        init = {n: scope.find_var(n).clone() for n in state}
        n_params = sum(scope.find_var(p.name).numel() for p, _ in params_grads)
    del scope
    counters = (conv_bn.fused_conv1x1_bn_fwd, multi_tensor.multi_tensor_update)
    paths, across = _train_both_paths(torch, pt, main_prog, feed, loss, init, RESNET_STEPS,
                                      counters)
    expected = {"executor": {"fused_conv1x1_bn_fwd": per_step * RESNET_STEPS,
                             "multi_tensor_update": RESNET_STEPS},
                "reference": {"fused_conv1x1_bn_fwd": 2 * per_step * RESNET_STEPS,
                              "multi_tensor_update": 0}}
    new = paths["executor"]
    emit("resnet_train_path",
         model=f"resnet50 NHWC space-to-depth stem bf16 B{RESNET_BATCH} 224x224 1000 classes "
               f"Momentum(0.1, 0.9), {fused} conv+bn chains fused",
         params=n_params, startup_s=startup_s,
         momentum_ops=ops.count("momentum"), paths=paths, expected_launches=expected,
         across_paths=across, loss_rel_limit=RESNET_LOSS_REL,
         update_rel_l1_limit=RESNET_UPDATE_REL,
         images_per_s=RESNET_BATCH / (new["step_ms_median_warm"] / 1e3))
    for path, want in expected.items():
        if paths[path]["launches"] != want:
            raise SystemExit(f"ResNet training launches on the {path} path "
                             f"{paths[path]['launches']}, expected {want}")
    losses = new["losses"]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise SystemExit(f"ResNet training loss is not finite and falling: {losses}")
    g = across["executor_vs_reference"]
    if not (g["step1_loss_equal"] and g["loss_rel_gap"] <= RESNET_LOSS_REL):
        raise SystemExit(f"ResNet training: the executor's path and the eager reference "
                         f"path part: {g}")
    launches, step_ms = new["launches"], new["step_ms_median_warm"]

    # step 1 from the same weights: the bf16 program (loss gaps held, update gaps
    # printed) and its f32 build (both held), each against the unfused program on
    # the card and, at batch 2, the CPU port (the same program: its batch is dynamic)
    init32 = {n: t.float() if t.is_floating_point() else t for n, t in init.items()}
    feed2 = _resnet_feed(torch, np.random.RandomState(SEED + 1), 2, "cpu")
    gaps = {}
    for dt in ("bfloat16", "float32"):
        tdt = getattr(torch, dt)
        if dt == "bfloat16":
            prog, prog_loss, ini = main_prog, loss, init
        else:
            prog, _, prog_loss, _, _ = build_resnet50(dtype=dt)
            ini = init32
        plain_prog, _, plain_loss, _, n0 = build_resnet50(dtype=dt, fuse=False)
        plain_state = {n for n, v in plain_prog.global_block().vars.items() if v.persistable}
        if n0 != 0 or plain_state != set(ini):
            raise SystemExit("the unfused ResNet-50 program names its state differently")
        fd = {"img": feed["img"].to(tdt), "label": feed["label"]}
        conv_bn.fused_conv1x1_bn_fwd.launches = 0
        fused_run = _resnet_step1(torch, pt, prog, prog_loss, ini, fd, "cuda")
        if conv_bn.fused_conv1x1_bn_fwd.launches != per_step:
            raise SystemExit(f"the {dt} step-1 card run did not run the conv1x1_bn kernel")
        unfused = _resnet_gaps(fused_run, _resnet_step1(torch, pt, plain_prog, plain_loss,
                                                        ini, fd, "cuda"))
        del plain_prog, fused_run
        torch.cuda.empty_cache()
        fd2 = {"img": feed2["img"].to(tdt), "label": feed2["label"]}
        t0 = time.perf_counter()
        cpu_run = _resnet_step1(torch, pt, prog, prog_loss, {n: t.cpu() for n, t in ini.items()},
                                fd2, "cpu")
        cpu_s = time.perf_counter() - t0
        card_run = _resnet_step1(torch, pt, prog, prog_loss, ini,
                                 {k: v.to("cuda") for k, v in fd2.items()}, "cuda")
        gaps[dt] = {"vs_card_unfused": unfused,
                    "vs_cpu_port_batch2": dict(_resnet_gaps(card_run, cpu_run), cpu_seconds=cpu_s)}
        del prog, card_run, cpu_run
        torch.cuda.empty_cache()
    emit("resnet_step1_gaps", **gaps, loss_rel_limit=RESNET_LOSS_REL,
         update_rel_l1_limit_f32=RESNET_UPDATE_REL)
    for dt, by_ref in gaps.items():
        for name, g in by_ref.items():
            held = g["loss_rel_gap"] <= RESNET_LOSS_REL
            if dt == "float32":
                held = held and g["update_rel_l1_gap"] <= RESNET_UPDATE_REL
            if not held:
                raise SystemExit(f"ResNet step 1 ({dt}) {name}: gaps {g} exceed the limits")
    return launches, step_ms, paths


def _update_inputs(torch, program, kind, gen):
    """Random inputs on the card for every ``kind`` op of ``program``, at its
    parameters' shapes and dtypes (grads in the parameter's dtype, state in
    f32), with the program's attrs: (the first op's attrs, the inputs, each
    op's attrs)."""
    from paddle_tpu_torch.core.registry import torch_dtype
    blk = program.global_block()
    ops = [op for op in blk.ops if op.type == kind]
    lr = torch.full((1,), {"adam": 1e-4, "momentum": 0.1, "sgd": 0.01, "lamb": 1e-4,
                           "lars_momentum": 0.1}[kind], device="cuda")
    ins_list = []
    for op in ops:
        pv = blk.var(op.input("Param")[0])
        dt, shape = torch_dtype(pv.dtype), tuple(pv.shape)
        rnd = lambda scale: torch.randn(shape, generator=gen, device="cuda") * scale
        ins = {"Param": [rnd(0.05).to(dt)], "Grad": [rnd(1e-3).to(dt)], "LearningRate": [lr]}
        if kind in ("adam", "lamb"):
            ins.update(Moment1=[rnd(1e-3)], Moment2=[rnd(1e-3).square()],
                       Beta1Pow=[torch.full((1,), 0.9 ** 3, device="cuda")],
                       Beta2Pow=[torch.full((1,), 0.999 ** 3, device="cuda")])
        elif kind in ("momentum", "lars_momentum"):
            ins["Velocity"] = [rnd(1e-3)]
        ins_list.append(ins)
    return ins_list, [dict(op.attrs) for op in ops]


def _plain_norms(torch, kind, op_attrs, ins_list):
    """Each tensor's two norms as the per-op lowering takes them (``torch.sum``
    of f32 squares on the card): |p| and |r| (lamb) or |g| (lars_momentum),
    [T, 2] f32."""
    out = []
    for a, ins in zip(op_attrs, ins_list):
        p, g = ins["Param"][0].float(), ins["Grad"][0].float()
        if kind == "lamb":
            b1, b2, eps = a.get("beta1", 0.9), a.get("beta2", 0.999), a.get("epsilon", 1e-6)
            m = b1 * ins["Moment1"][0] + (1 - b1) * g
            v = b2 * ins["Moment2"][0] + (1 - b2) * g * g
            q = (m / (1 - ins["Beta1Pow"][0])) / (torch.sqrt(v / (1 - ins["Beta2Pow"][0])) + eps) \
                + a.get("weight_decay", 0.01) * p
        else:
            q = g
        out.append(torch.stack([torch.sqrt(torch.sum(p * p)), torch.sqrt(torch.sum(q * q))]))
    return torch.stack(out)


def _given_norms(torch, kind, op_attrs, ins_list, ref, norms):
    """What the kernel's second pass writes, computed with PyTorch's f32
    elementwise ops from the kernel's own norms (``norms``, [T, 2]) and the
    lowering's bit-exact moments (``ref``, lamb): ParamOut (and lars_momentum's
    VelocityOut) of each op."""
    outs = []
    for t, (a, ins, r) in enumerate(zip(op_attrs, ins_list, ref)):
        p = ins["Param"][0]
        pf, lr = p.float(), ins["LearningRate"][0]
        pn, qn = norms[t, 0:1], norms[t, 1:2]
        if kind == "lamb":
            m, v = r["Moment1Out"][0], r["Moment2Out"][0]
            rr = (m / (1 - ins["Beta1Pow"][0])) / (torch.sqrt(v / (1 - ins["Beta2Pow"][0]))
                                                   + a.get("epsilon", 1e-6)) \
                + a.get("weight_decay", 0.01) * pf
            trust = torch.where((pn > 0) & (qn > 0), pn / qn, torch.ones_like(pn))
            outs.append({"ParamOut": (pf - (lr * trust) * rr).to(p.dtype)})
        else:
            coeff, decay = a.get("lars_coeff", 0.001), a.get("lars_weight_decay", 0.0005)
            local = torch.where(pn > 0, lr * coeff * pn / (qn + decay * pn + 1e-12), lr)
            vel = a.get("mu", 0.9) * ins["Velocity"][0] + local * (ins["Grad"][0].float()
                                                                   + decay * pf)
            outs.append({"ParamOut": (pf - vel).to(p.dtype), "VelocityOut": vel})
    return outs


def _lars_velocity_excess(torch, op_attrs, ins_list, outs, ref, norms):
    """How far each lars_momentum VelocityOut lies beyond its bound (<= 0:
    within): v' = mu v + L u (u = g + decay p, L the local learning rate) is
    held to 4 f32 roundings of |mu v| + |L u| plus 2 NORM_REL of |L u|, the
    error that L's norms (each within NORM_REL) and the sum's roundings allow.
    Where the two terms cancel, that is many ulps of v' itself."""
    worst = -1.0
    for t, (a, ins, o, r) in enumerate(zip(op_attrs, ins_list, outs, ref)):
        pf, lr = ins["Param"][0].float(), ins["LearningRate"][0]
        pn, gn = norms[t, 0:1], norms[t, 1:2]
        coeff, decay = a.get("lars_coeff", 0.001), a.get("lars_weight_decay", 0.0005)
        local = torch.where(pn > 0, lr * coeff * pn / (gn + decay * pn + 1e-12), lr)
        term = (local * (ins["Grad"][0].float() + decay * pf)).abs()
        base = (a.get("mu", 0.9) * ins["Velocity"][0]).abs()
        bound = 4 * 2.0 ** -24 * (base + term) + 2 * NORM_REL * term
        diff = (o["VelocityOut"][0] - r["VelocityOut"][0]).abs()
        worst = max(worst, float((diff - bound).max()))
    return worst


#: the normed kinds' limits against the per-op lowerings: the moments bit for
#: bit (no reduction reaches them); each tensor's norms within 1e-6 relative
#: of torch.sum's (two f32 sums of squares in other orders, each about 1e-7
#: relative); ParamOut within 2 f32 ulps, 1 for a bf16 parameter (the update is
#: ~1e-4 of the parameter, so a norm's 1e-6 moves its f32 value by well under
#: an ulp, and a bf16 value by at most one rounding); lars_momentum's
#: VelocityOut, a sum of two terms that can cancel, within its error bound
#: (``_lars_velocity_excess``); bit for bit to the same arithmetic fed the
#: kernel's own norms; two runs bit for bit
NORM_REL, NORMED_F32_ULP, NORMED_BF16_ULP = 1e-6, 2, 1
_NORMED_EXACT = {"lamb": ("Moment1Out", "Moment2Out", "Beta1PowOut", "Beta2PowOut"),
                 "lars_momentum": ()}


def _normed_checks(torch, kind, op_attrs, ins_list):
    """A lamb / lars_momentum run through the kernel twice (with its norms
    read back) and through the per-op lowerings, each on its own copy of the
    inputs, held to the limits above."""
    from paddle_tpu_torch.ops.multi_tensor import multi_tensor_update, update_plain
    copies = [[{s: [t.clone() for t in v] for s, v in ins.items()} for ins in ins_list]
              for _ in range(3)]
    T = len(ins_list)
    norms = [torch.empty((T, 2), dtype=torch.float32, device="cuda") for _ in range(2)]
    outs = multi_tensor_update(kind, op_attrs, copies[0], norms=norms[0])
    again = multi_tensor_update(kind, op_attrs, copies[1], norms=norms[1])
    ref = update_plain(kind, op_attrs, copies[2])
    plain = _plain_norms(torch, kind, op_attrs, ins_list)
    given = _given_norms(torch, kind, op_attrs, ins_list, ref, norms[0])
    torch.cuda.synchronize()
    in_place = all(out["ParamOut"][0] is ins["Param"][0] for out, ins in zip(outs, copies[0]))
    self_equal = torch.equal(norms[0], norms[1]) and all(
        torch.equal(o[s][0], o2[s][0]) for o, o2 in zip(outs, again) for s in o)
    norm_rel = float(((norms[0] - plain).abs() / plain.abs().clamp_min(1e-30)).max())
    exact = all(torch.equal(o[s][0], r[s][0]) for o, r in zip(outs, ref)
                for s in _NORMED_EXACT[kind])
    given_equal = all(torch.equal(o[s][0], gv[s]) for o, gv in zip(outs, given) for s in gv)
    ulp = {"float32": 0, "bfloat16": 0}
    err, finite = 0.0, True
    for o, r in zip(outs, ref):
        a, b = o["ParamOut"][0], r["ParamOut"][0]
        key = str(a.dtype)[6:]
        ulp[key] = max(ulp[key], _max_ulp(torch, a, b))
        for s in o:
            err = max(err, (o[s][0].float() - r[s][0].float()).abs().max().item())
            finite &= bool(torch.isfinite(o[s][0]).all())
    velocity = None
    if kind == "lars_momentum":
        velocity = dict(
            max_ulp=max(_max_ulp(torch, o["VelocityOut"][0], r["VelocityOut"][0])
                        for o, r in zip(outs, ref)),
            max_excess_over_bound=_lars_velocity_excess(torch, op_attrs, ins_list, outs, ref,
                                                        norms[0]))
    ok = (in_place and self_equal and exact and given_equal and finite
          and norm_rel <= NORM_REL and ulp["float32"] <= NORMED_F32_ULP
          and ulp["bfloat16"] <= NORMED_BF16_ULP
          and (velocity is None or velocity["max_excess_over_bound"] <= 0))
    del copies, outs, again, ref, given
    return dict(in_place=in_place, two_runs_bit_equal=self_equal,
                state_bit_exact=exact, exact_slots=list(_NORMED_EXACT[kind]),
                bit_equal_given_kernel_norms=given_equal,
                norm_max_rel_err=norm_rel, norm_rel_limit=NORM_REL, max_ulp=ulp,
                velocity=velocity,
                ulp_limits={"float32": NORMED_F32_ULP, "bfloat16": NORMED_BF16_ULP},
                max_abs_err=err, ok=ok,
                weight_decays=sorted({a.get("weight_decay", 0.01) for a in op_attrs})
                if kind == "lamb" else None)


def _wall_ms(torch, fn, runs=5):
    """Median host time of one synchronised call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _host_ms(torch, fn, runs=5):
    """Median host time of one call until it returns (the device work it
    queued is waited for outside the timed region)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


#: the multi_tensor_update.cu kernels a call launches (by name in a trace)
KERNEL_NAMES = ("multi_tensor_kernel", "beta_pow_kernel", "norm_pass_kernel",
                "apply_pass_kernel")


def phase_multi_tensor(torch, programs):
    """multi_tensor_update over each model's parameter list against the
    per-op lowerings on the card (bit for bit), with times, the bound and
    PyTorch's fused optimizers as yardsticks."""
    from paddle_tpu_torch.ops.multi_tensor import (LAUNCHES_PER_CALL, NORMED,
                                                   multi_tensor_update, update_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    results = []
    for model, program, kind in programs:
        ins_list, op_attrs = _update_inputs(torch, program, kind, gen)
        attrs = op_attrs[0]
        normed = None
        if kind in NORMED:
            normed = _normed_checks(torch, kind, op_attrs, ins_list)
            in_place, exact, ulp, err = (normed["in_place"], normed["ok"], normed["max_ulp"],
                                         normed["max_abs_err"])
            finite = True
        else:
            # the update is in place: the kernel twice and the per-op lowerings,
            # each on its own copy of the inputs
            copies = [[{s: [t.clone() for t in v] for s, v in ins.items()} for ins in ins_list]
                      for _ in range(3)]
            outs = multi_tensor_update(kind, op_attrs, copies[0])
            again = multi_tensor_update(kind, op_attrs, copies[1])
            ref = update_plain(kind, op_attrs, copies[2])
            torch.cuda.synchronize()
            in_place = all(out["ParamOut"][0] is ins["Param"][0]
                           for out, ins in zip(outs, copies[0]))
            exact, ulp, err, finite = in_place, 0, 0.0, True
            for out, out2, r in zip(outs, again, ref):
                for slot in r:
                    a, a2, b = out[slot][0], out2[slot][0], r[slot][0]
                    same = a.dtype == b.dtype and torch.equal(a, b) and torch.equal(a, a2)
                    exact &= same
                    finite &= bool(torch.isfinite(a).all())
                    if not same:
                        ulp = max(ulp, _max_ulp(torch, a, b))
                        err = max(err, (a.float() - b.float()).abs().max().item())
            del outs, again, ref, copies
        call = lambda: multi_tensor_update(kind, op_attrs, ins_list)
        plain_call = lambda: update_plain(kind, op_attrs, ins_list)
        # device times from the profiler: the host work of a call (the work table
        # for ~200 tensors, ~2,000 launches for the per-op path) outlasts any
        # queue of sleep a CUDA-event window could put before it
        launches = _launch_times(torch, call, 3)
        # the kernel launches of one call, counted in the graph that captures it
        # and held to what the wrapper states (LAUNCHES_PER_CALL); the kernels
        # line multiplies this count by each path's calls
        counted = _graph_launches(torch, call, KERNEL_NAMES)
        launches_per_call = sum(counted.values())
        # a kernel's ms a call: its mean over the launches the trace kept, times
        # its launches a call (late in the run a trace can lose its first record)
        traced_ = {n: [x for x in launches if n in x["kernel"]] for n in KERNEL_NAMES}
        trace_launches_per_call = sum(x["launches_per_call"] for v in traced_.values()
                                      for x in v)
        ms = sum(counted[n] * sum(x["ms_per_launch"] * x["launches_per_call"] for x in v)
                 / sum(x["launches_per_call"] for x in v)
                 for n, v in traced_.items() if v and counted[n])
        ms_complete = all(traced_[n] for n in KERNEL_NAMES if counted[n])
        table_copy_ms = sum(x["ms_per_launch"] * x["launches_per_call"] for x in launches
                            if "Memcpy" in x["kernel"])
        plain = _breakdown("update_plain", None, _launch_times(torch, plain_call, 1))
        plain_ms, plain_launches = plain["device_ms_per_call"], plain["launches_per_call"]
        wall_ms = _wall_ms(torch, call)
        host_ms = _host_ms(torch, call)
        plain_wall_ms = _wall_ms(torch, plain_call)
        # bytes the function must move: read p, g and the state, write p and the
        # state (the scalars are noise)
        state = {"adam": 2, "momentum": 1, "sgd": 0, "lamb": 2, "lars_momentum": 1}[kind]
        nbytes = sum(ins["Param"][0].numel() * (2 * ins["Param"][0].element_size()
                                                + ins["Grad"][0].element_size() + 8 * state)
                     for ins in ins_list)
        # what the two-pass design moves: lamb reads p, g, m, v and writes m, v, then
        # reads p, m, v and writes p; lars_momentum reads p and g, then p, g, v and
        # writes v and p
        pe = lambda ins: ins["Param"][0].element_size()
        ge = lambda ins: ins["Grad"][0].element_size()
        design = {"lamb": lambda ins: 3 * pe(ins) + ge(ins) + 24,
                  "lars_momentum": lambda ins: 3 * pe(ins) + 2 * ge(ins) + 8}
        design_bytes = sum(ins["Param"][0].numel() * design[kind](ins)
                           for ins in ins_list) if kind in design else None
        n = sum(ins["Param"][0].numel() for ins in ins_list)
        # yardstick: PyTorch's fused optimizer on f32 copies (its kernel takes one dtype
        # for a parameter and its state); Paddle's Adam adds eps to sqrt(v) after the
        # bias correction folds into lr, so the bits differ from PyTorch's anyway
        copies = lambda k: [ins[k][0].float().clone() for ins in ins_list] \
            if k in ins_list[0] else []
        ps, gs = copies("Param"), copies("Grad")
        ms_ = copies("Moment1" if kind in ("adam", "lamb") else "Velocity")
        vs = copies("Moment2")
        library, library_ms, library_error = None, None, None
        try:
            if kind in ("adam", "lamb"):
                library = "torch._fused_adam_ (f32 copies)"
                steps = [torch.ones((), device="cuda") for _ in ps]
                fn = lambda: torch._fused_adam_(ps, gs, ms_, vs, [], steps, lr=1e-4,
                                                beta1=attrs["beta1"], beta2=attrs["beta2"],
                                                weight_decay=0.0, eps=attrs["epsilon"],
                                                amsgrad=False, maximize=False)
            elif kind in ("momentum", "lars_momentum"):
                library = "torch._fused_sgd_ (f32 copies)"
                fn = lambda: torch._fused_sgd_(ps, gs, ms_, weight_decay=0.0,
                                               momentum=attrs["mu"], lr=0.1, dampening=0.0,
                                               nesterov=bool(attrs.get("use_nesterov", False)),
                                               maximize=False, is_first_step=False)
            else:
                library = "torch._fused_sgd_ without momentum (f32 copies)"
                fn = lambda: torch._fused_sgd_(ps, gs, [], weight_decay=0.0, momentum=0.0,
                                               lr=0.01, dampening=0.0, nesterov=False,
                                               maximize=False, is_first_step=False)
            library_ms = _breakdown(library, None, _launch_times(torch, fn, 3))[
                "device_ms_per_call"]
        except (RuntimeError, TypeError) as e:      # a yardstick only: record why
            library_error = f"{type(e).__name__}: {e}"[:200]
        del ps, gs, ms_, vs
        yardstick_ms = None
        if kind in NORMED:
            # no PyTorch call computes LAMB or LARS: the fused Adam / SGD is a yardstick
            yardstick, yardstick_ms = library, library_ms
            library, library_ms = ("none (no single PyTorch call computes it); yardstick "
                                   + yardstick), None
        r = dict(model=model, kind=kind, attrs=attrs, tensors=len(ins_list), elements=n,
                 param_dtypes=sorted({str(ins["Param"][0].dtype)[6:] for ins in ins_list}),
                 in_place=in_place, bit_exact=exact, max_ulp=ulp, max_abs_err=err,
                 launches_per_call=launches_per_call,
                 launches_per_call_stated=LAUNCHES_PER_CALL[kind],
                 trace_launches_per_call=trace_launches_per_call,
                 ok=exact and finite and ms > 0 and ms_complete
                 and launches_per_call == LAUNCHES_PER_CALL[kind],
                 ms=ms, table_copy_ms=table_copy_ms, plain_ms=plain_ms,
                 plain_launches_per_call=plain_launches, wall_ms=wall_ms, host_ms=host_ms,
                 plain_wall_ms=plain_wall_ms,
                 bytes=nbytes,
                 bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                 library=library, library_ms=library_ms, library_error=library_error,
                 yardstick_ms=yardstick_ms, normed=normed, design_bytes=design_bytes,
                 design_bytes_ms=design_bytes / HBM_BYTES_PER_S * 1e3 if design_bytes else None)
        emit("kernel_vs_plain", kernel="multi_tensor_update", **r)
        results.append(r)
        del ins_list
        torch.cuda.empty_cache()
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise SystemExit(f"multi_tensor_update parts from the per-op lowerings beyond its "
                         f"limits: {bad}")
    return results


# BERT-base's hidden dropout: [B * S, 768] at B128 S128, p 0.1
DROPOUT_SHAPE, DROPOUT_P = (128 * 128, 768), 0.1
# transformer-base's attention-probs dropout: [B, heads, S, S] at B64 S64, f32
NMT_PROBS_DROPOUT_SHAPE = (64, 8, 64, 64)
# VGG-16's two fc dropouts in the image chapter: [B, 4096] at B128, f32, p 0.5,
# layers.dropout's default downgrade_in_infer (no upscale)
VGG_DROPOUT_SHAPE, VGG_DROPOUT_P = (128, 4096), 0.5
# steps held graph against eager, and steps timed on each path after them
# (5 and 5 until phase 30 was added; cut for the script's time)
CAPTURED_STEPS = 3
TIMED_STEPS = 3
# an eager path, host-bound and the slower one, is timed over fewer steps (the
# one after its first); each path is traced over one step (after the
# profiler's warm-up step), to keep the whole script near half its time limit
EAGER_TIMED_STEPS, PROFILED_STEPS = 2, 1
FUSED_K = 4


def phase_seed_counter(torch):
    """The run counter on the card: K1-fwd, K1-bwd and the dropout kernel,
    given a ``DeviceSeed`` over a counter tensor, draw exactly what they
    draw for the host seed ``seed_int`` of that counter (bit for bit, at the
    training shape), for counters 0, 1, 2^31 and 2^32 + 5; the plain
    versions' key from the counter on the card equals it too; and two
    counters give two outputs."""
    from paddle_tpu_torch.core.registry import DeviceSeed, seed_int
    from paddle_tpu_torch.ops import dropout as dmod
    from paddle_tpu_torch.ops.flash_attention import (flash_attn_bwd, flash_attn_fwd,
                                                      philox_key)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    q, k, v, bias = _attn_inputs(torch, 128, 12, 128, 64, torch.bfloat16, True, gen)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    x = torch.randn(DROPOUT_SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
    prog_seed, salt, p = 0x5EED, 2 ** 31 - 3, ATTN_DROPOUT
    counter = torch.zeros((1,), dtype=torch.int64, device="cuda")
    rows, outs = [], {}
    for c in (0, 1, 2 ** 31, 2 ** 32 + 5):
        counter.fill_(c)
        dev, host = DeviceSeed(counter, prog_seed, salt), seed_int(prog_seed, c, salt)
        o1, l1 = flash_attn_fwd(q, k, v, bias, 0.125, False, p, dev, return_lse=True)
        o2, l2 = flash_attn_fwd(q, k, v, bias, 0.125, False, p, host, return_lse=True)
        g1 = flash_attn_bwd(q, k, v, bias, o1, l1, do, 0.125, False, p, dev)
        g2 = flash_attn_bwd(q, k, v, bias, o2, l2, do, 0.125, False, p, host)
        d1, d2 = dmod.dropout_fwd(x, DROPOUT_P, True, dev), dmod.dropout_fwd(x, DROPOUT_P, True, host)
        k0, k1 = philox_key(dev)
        rows.append(dict(counter=c, seed=host,
                         flash_attn_fwd=torch.equal(o1, o2) and torch.equal(l1, l2),
                         flash_attn_bwd=all(torch.equal(a, b) for a, b in zip(g1, g2)),
                         dropout=torch.equal(d1[0], d2[0]) and torch.equal(d1[1], d2[1]),
                         plain_key=(int(k1) << 32 | int(k0)) == host))
        outs[c] = (o1, d1[1])
    differ = not torch.equal(outs[0][0], outs[1][0]) and not torch.equal(outs[0][1], outs[1][1])
    ok = differ and all(all(v for k_, v in r.items() if k_ not in ("counter", "seed"))
                        for r in rows)
    emit("seed_counter", shape="flash B128 H12 S128 D64 bf16 bias p 0.1; dropout "
         f"{list(DROPOUT_SHAPE)} bf16 p {DROPOUT_P}", rows=rows,
         counters_draw_different_masks=differ, ok=ok)
    if not ok:
        raise SystemExit(f"the kernels' seed from the run counter on the card differs from "
                         f"seed_int's: {rows}, differ={differ}")


def _hbm_from_card(torch):
    """The card's own peak memory rate (bytes/s), from its memory clock and
    bus width where PyTorch reports them (double data rate), else None."""
    props = torch.cuda.get_device_properties(0)
    clock_khz = getattr(props, "memory_clock_rate", None)
    bus_bits = getattr(props, "memory_bus_width", None)
    if not clock_khz or not bus_bits:
        return None
    return 2 * clock_khz * 1e3 * bus_bits / 8


def phase_dropout_kernel(torch):
    """The dropout kernel against its plain version on the card, bit for bit
    (Out and Mask, and a second launch), at BERT-base's hidden-dropout shape
    in both implementations, at transformer-base's and VGG-16's, in f32, at
    a ragged size, on an unaligned view (the one-element path) and at p 0
    and 1; at the paths' shapes its time, the plain version's,
    ``F.dropout``'s (the library yardstick: another RNG, the same work) and
    the bound (read X, write Out and Mask)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import dropout as dmod
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 12)
    # (shape, dtype, upscale, p, element offset, timed)
    cases = [(DROPOUT_SHAPE, "bfloat16", True, DROPOUT_P, 0, True),
             (DROPOUT_SHAPE, "bfloat16", False, DROPOUT_P, 0, True),
             (NMT_PROBS_DROPOUT_SHAPE, "float32", True, DROPOUT_P, 0, True),
             (VGG_DROPOUT_SHAPE, "float32", False, VGG_DROPOUT_P, 0, True),
             ((4096, 768), "float32", True, DROPOUT_P, 0, False),
             ((1001, 77), "bfloat16", True, 0.3, 0, False),
             ((4096, 768), "bfloat16", True, DROPOUT_P, 1, False),
             ((333,), "float32", True, 1.0, 0, False),
             ((333,), "bfloat16", False, 0.0, 0, False)]
    hbm_card = _hbm_from_card(torch)
    results = []
    for i, (shape, dt, upscale, p, off, timed) in enumerate(cases):
        dtype = getattr(torch, dt)
        n = int(np.prod(shape))
        x = torch.randn(n + off, generator=gen, device="cuda").to(dtype)[off:].view(shape)
        seed = 0x9E3779B97F4A7C15 + i
        out, mask = dmod.dropout_fwd(x, p, upscale, seed)
        out2, mask2 = dmod.dropout_fwd(x, p, upscale, seed)
        ref_out, ref_mask = dmod.dropout_plain(x, p, upscale, seed)
        torch.cuda.synchronize()
        exact = (torch.equal(out, ref_out) and torch.equal(mask, ref_mask)
                 and torch.equal(out, out2) and torch.equal(mask, mask2))
        err = (out.float() - ref_out.float()).abs().max().item()
        keep = mask.float().mean().item()
        r = dict(shape=list(shape), dtype=dt, upscale=upscale, p=p, element_offset=off,
                 bit_exact=exact, max_abs_err=err, keep_fraction=keep, ok=exact)
        if timed:
            nbytes = 3 * n * x.element_size()
            r.update(ms=_device_ms(torch, lambda: dmod.dropout_fwd(x, p, upscale, seed)),
                     plain_ms=_device_ms(torch, lambda: dmod.dropout_plain(x, p, upscale, seed),
                                         runs=5),
                     library="torch.nn.functional.dropout (its own RNG)",
                     library_ms=_device_ms(torch, lambda: F.dropout(x, p, training=True)),
                     bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                     bound_ms_card_rate=(nbytes / hbm_card * 1e3) if hbm_card else None,
                     card_hbm_bytes_per_s=hbm_card)
        emit("kernel_vs_plain", kernel="dropout", **r)
        results.append(r)
        del x, out, mask, out2, mask2, ref_out, ref_mask
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise SystemExit(f"the dropout kernel disagrees with its plain version: {bad}")
    return results


def phase_row_grads(torch):
    """The gradients of lookup_table_v2 and gather at BERT-base's shapes and
    at DeepFM's (the 1,000,000-row tables ``fm_v`` and ``fm_w1``, 106,496
    ids a step), on the card: PyTorch's (``F.embedding`` / ``index_select``
    backward, which add with atomics) against the port's ``RowGather``
    (sorted accumulation): device time of the backward alone, and whether
    two runs give the same bits."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.tensor_ops import RowGather
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 13)
    rng = np.random.RandomState(SEED)
    B, S, V, Hd = 128, 128, 30522, 768
    cases = [("lookup_table_v2 word_emb", (V, Hd), torch.float32, rng.randint(0, V, B * S), "emb"),
             ("lookup_table_v2 pos_emb", (512, Hd), torch.float32,
              np.tile(np.arange(S), B), "emb"),
             ("lookup_table_v2 sent_emb", (2, Hd), torch.float32, rng.randint(0, 2, B * S), "emb"),
             ("gather mlm positions", (B * S, Hd), torch.bfloat16,
              rng.randint(0, B * S, B * 20), "gather")]
    # DeepFM (phase 14): bench_workloads.py's ids, B 4096 x 26 fields over 1M rows
    ctr_ids = np.random.RandomState(SEED).randint(0, 1_000_000, 4096 * 26)
    cases += [("lookup_table_v2 fm_v (deepfm)", (1_000_000, 16), torch.float32, ctr_ids, "emb"),
              ("lookup_table_v2 fm_w1 (deepfm)", (1_000_000, 1), torch.float32, ctr_ids, "emb")]
    results = []
    for name, shape, dtype, ids, kind in cases:
        w = torch.randn(shape, generator=gen, device="cuda").to(dtype).requires_grad_()
        idx = torch.from_numpy(ids.astype(np.int64)).cuda()
        before = (lambda: F.embedding(idx, w)) if kind == "emb" else \
            (lambda: w.index_select(0, idx))
        ys = {"before": before(), "after": RowGather.apply(w, idx)}
        g = torch.randn(ys["after"].shape, generator=gen, device="cuda").to(dtype)
        r = dict(op=name, weight=list(shape), dtype=str(dtype)[6:], indices=len(ids))
        grads = {}
        for which, y in ys.items():
            fn = lambda: torch.autograd.grad(y, w, g, retain_graph=True)[0]
            a, b = fn(), fn()
            grads[which] = a
            r[f"{which}_ms"] = _device_ms(torch, fn, runs=10)
            r[f"{which}_reproducible"] = torch.equal(a, b)
        r["max_abs_gap"] = (grads["before"].float() - grads["after"].float()).abs().max().item()
        emit("row_grads", **r)
        results.append(r)
        del w, ys, grads
    if not all(r["after_reproducible"] for r in results):
        raise SystemExit(f"RowGather's gradient does not reproduce: {results}")
    return results


def _steps(pt, exe, main, feed, fetch, init, steps):
    """``steps`` runs from ``init`` in a scope of their own, the counter from
    0: (each step's fetches as tensors, the final state, the scope)."""
    scope = pt.Scope()
    for n, t in init.items():
        scope.set_var(n, t.clone())
    main._rng_run_counter = 0
    with pt.scope_guard(scope):
        outs = [exe.run(main, feed=feed, fetch_list=fetch, return_numpy=False)
                for _ in range(steps)]
    return outs, {n: scope.find_var(n) for n in init}, scope


def _graph_pools(exe):
    return [s.graph.memory_bytes / 1e9 for s in exe._cache.values() if s.graph is not None]


def _timed_path(torch, pt, main, feed, loss, init, graphs_on, free_dead):
    """Step ms of each of TIMED_STEPS steps (EAGER_TIMED_STEPS eager; fetching
    the loss as numpy), the peak of allocated memory over them and the graph
    pools, then PROFILED_STEPS steps under the profiler, with
    the window's device records by name: their count and ms over its steps.
    The executor is closed at the end."""
    from paddle_tpu_torch.tools.train_profile import profile_steps
    exe = pt.Executor()
    exe._use_graphs, exe._free_dead = graphs_on, free_dead
    scope = pt.Scope()
    for n, t in init.items():
        scope.set_var(n, t.clone())
    main._rng_run_counter = 0
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times = []
    with pt.scope_guard(scope):
        for _ in range(TIMED_STEPS if graphs_on else EAGER_TIMED_STEPS):
            t0 = time.perf_counter()
            exe.run(main, feed=feed, fetch_list=[loss])
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 1e9
        pools = _graph_pools(exe)
        prof = profile_steps(torch, exe, main, feed, loss, PROFILED_STEPS)
    exe.close()
    del scope, exe
    warm = times[2:] if graphs_on else times[1:]     # after the warm-up (and the capture)
    ms = statistics.median(warm)
    return dict(step_ms=times, step_ms_median_warm=ms, peak_gb=peak, graph_pool_gb=pools,
                device_busy_ms=prof["device_busy_ms"],
                idle_share_profiled=prof["device_idle_share"],
                idle_share_unprofiled=max(0.0, 1 - prof["device_busy_ms"] / ms),
                profiled_wall_ms=prof["wall_ms"],
                device_activities_per_step=prof["device_activities_per_step"],
                by_kind=prof["by_kind"], device_records=prof["device_records"],
                device_ms_by_record=prof["device_ms_by_record"])


def _memory_before_after(torch, pt, main, feed, loss, init, freed):
    """Part 6: the eager step's peak and the graph's pool with every
    intermediate kept to the step's end, measured here, beside ``freed``:
    the same two with each freed after its last reader (the executor's
    default), as the held graph path and the timed eager path measured
    them."""
    row = {}
    for graphs_on in (False, True):
        exe = pt.Executor()
        exe._use_graphs, exe._free_dead = graphs_on, False
        scope = pt.Scope()
        for n, t in init.items():
            scope.set_var(n, t.clone())
        gc.collect()                    # what an earlier executor left in cycles
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with pt.scope_guard(scope):
            for _ in range(2):          # graphs: the warm-up, then the capture
                exe.run(main, feed=feed, fetch_list=[loss])
        if graphs_on:
            row["graph_pool_gb"] = _graph_pools(exe)[0]
        else:
            row["eager_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        exe.close()
        del scope, exe
    return {"kept_to_step_end": row, "freed_after_last_reader": freed}


def _state_equal(torch, a, b):
    return [n for n in b if not torch.equal(a[n], b[n])]


def _startup_state(pt, main, startup):
    """The persistable state of ``main`` after ``startup`` runs on the card."""
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt.Executor().run(startup)
        return {n: scope.find_var(n).clone() for n, v in main.global_block().vars.items()
                if v.persistable and scope.find_var(n) is not None}


def _captured_model(torch, pt, label, main, startup, feed, loss, expected, extra_fetch,
                    init=None, final=None, masks=True, reference=False):
    """Graph executor against the eager executor (``_use_graphs = False``) on
    one model: CAPTURED_STEPS steps from the same state (``init``, else the
    startup program's), losses and every state tensor compared bit for bit,
    the eager path against itself (its run-to-run noise); ``run_fused`` (K =
    FUSED_K) against K ``run`` calls; then each path timed and profiled, and
    the memory before and after freeing dead intermediates. ``final``, a dict, receives the graph path's state after
    its CAPTURED_STEPS steps. ``extra_fetch`` is a dropout op's Mask
    (``masks``), checked to follow the run counter, or other fetches (a
    metric), held bit for bit between the paths. ``reference`` adds the
    eager reference path (``_reuse_forward = _group_updates = False``),
    held bit for bit against the eager path."""
    from paddle_tpu_torch.core import cuda_build
    if init is None:
        init = _startup_state(pt, main, startup)
    fetch = [loss] + extra_fetch
    runs, launches = {}, {}
    paths = ("graph", "eager", "eager_again") + (("reference",) if reference else ())
    for path in paths:
        exe = pt.Executor()
        exe._use_graphs = path == "graph"
        if path == "reference":
            exe._reuse_forward = exe._group_updates = False
        for fn in cuda_build.COUNTED:
            fn.launches = 0
        outs, state, scope = _steps(pt, exe, main, feed, fetch, init, CAPTURED_STEPS)
        torch.cuda.synchronize()
        launches[path] = {fn.__name__: fn.launches for fn in cuda_build.COUNTED if fn.launches}
        runs[path] = (outs, {n: t.clone() for n, t in state.items()})
        if path == "graph":
            pools = _graph_pools(exe)
            if final is not None:
                final.update(runs[path][1])
        exe.close()
        del exe, scope, outs, state
    (g_outs, g_state), (e_outs, e_state), (e2_outs, e2_state) = (
        runs["graph"], runs["eager"], runs["eager_again"])
    losses = {p: [float(o[0].float().reshape(-1)[0]) for o in runs[p][0]] for p in runs}
    loss_equal = [torch.equal(a[0], b[0]) for a, b in zip(g_outs, e_outs)]
    state_differs = _state_equal(torch, g_state, e_state)
    eager_differs = _state_equal(torch, e2_state, e_state)
    eager_loss_equal = [torch.equal(a[0], b[0]) for a, b in zip(e2_outs, e_outs)]
    deterministic = not eager_differs and all(eager_loss_equal)
    r = dict(model=label, steps=CAPTURED_STEPS, losses=losses, loss_bit_equal=loss_equal,
             state_tensors=len(init), state_differs=len(state_differs),
             state_differs_first=state_differs[:8], eager_vs_eager_state_differs=len(eager_differs),
             eager_deterministic=deterministic, graph_pool_gb=pools, launches=launches,
             expected_launches_per_step=expected, counter_after=main._rng_run_counter)
    if not deterministic or state_differs:
        r["update_rel_l1_gap"] = _update_gap(init, g_state, e_state)
        r["eager_update_rel_l1_gap"] = _update_gap(init, e2_state, e_state)
    if reference:
        r_outs, r_state = runs["reference"]
        r["reference_loss_bit_equal"] = [torch.equal(a[0], b[0]) for a, b in zip(r_outs, e_outs)]
        r["reference_state_differs"] = len(_state_equal(torch, r_state, e_state))
        r["reference_extra_fetch_bit_equal"] = all(
            torch.equal(x, y) for a, b in zip(r_outs, e_outs) for x, y in zip(a[1:], b[1:]))
        del r_outs, r_state
    if extra_fetch and not masks:       # a metric: every step's value, bit for bit
        r["extra_fetch"] = [[float(x.double().reshape(-1)[0]) for x in o[1:]] for o in g_outs]
        r["extra_fetch_bit_equal"] = all(
            torch.equal(x, y) for a, b in zip(g_outs, e_outs) for x, y in zip(a[1:], b[1:]))
    if extra_fetch and masks:           # a dropout op's Mask at steps 1 and 2
        m = [(o[1], e[1]) for o, e in zip(g_outs[:2], e_outs[:2])]
        r["mask_step1_equal"] = torch.equal(*m[0])
        r["mask_step2_equal"] = torch.equal(*m[1])
        r["mask_differs_between_steps"] = not torch.equal(m[0][0], m[1][0])
        r["mask_keep_fraction"] = m[0][0].float().mean().item()
    del runs, g_outs, e_outs, e2_outs, g_state, e_state, e2_state

    # run_fused (K = FUSED_K) against K run calls, both on graphs, from init
    fused = {}
    for how in ("run_fused", "run"):
        exe = pt.Executor()
        scope = pt.Scope()
        for n, t in init.items():
            scope.set_var(n, t.clone())
        main._rng_run_counter = 0
        with pt.scope_guard(scope):
            if how == "run_fused":
                l, = exe.run_fused(main, feeds=[feed] * FUSED_K, fetch_list=[loss])
            else:
                l = torch.stack([exe.run(main, feed=feed, fetch_list=[loss],
                                         return_numpy=False)[0] for _ in range(FUSED_K)])
        fused[how] = (l.clone(), {n: scope.find_var(n).clone() for n in init},
                      main._rng_run_counter)
        exe.close()
        del exe, scope
    (fl, fs, fc), (rl, rs, rc) = fused["run_fused"], fused["run"]
    r["run_fused"] = dict(K=FUSED_K, shape=list(fl.shape), losses_bit_equal=torch.equal(fl, rl),
                          state_differs=len(_state_equal(torch, fs, rs)),
                          counter_after=[fc, rc])
    del fused, fs, rs

    r["paths"] = {("graph" if g else "eager"): _timed_path(torch, pt, main, feed, loss, init, g,
                                                           True)
                  for g in (True, False)}
    r["memory_before_after_freeing"] = _memory_before_after(
        torch, pt, main, feed, loss, init,
        {"eager_peak_gb": r["paths"]["eager"]["peak_gb"], "graph_pool_gb": pools[0]})
    r["graph_speedup"] = (r["paths"]["eager"]["step_ms_median_warm"]
                          / r["paths"]["graph"]["step_ms_median_warm"])
    emit("captured_training", **r)

    # checks
    per_step = {k: v * CAPTURED_STEPS for k, v in expected.items()}
    for path in ("graph", "eager"):
        got = {k: launches[path].get(k, 0) for k in per_step}
        if got != per_step:
            raise SystemExit(f"{label}: launches on the {path} path {got}, expected {per_step}")
    if not all(np.isfinite(losses["graph"])):
        raise SystemExit(f"{label}: losses not finite: {losses['graph']}")
    if not loss_equal[0]:
        raise SystemExit(f"{label}: step 1's loss differs between graph and eager")
    if deterministic:
        if not (all(loss_equal) and not state_differs):
            raise SystemExit(f"{label}: the graph path parts from the eager path bit for bit "
                             f"(losses {loss_equal}, {len(state_differs)} state tensors)")
    elif r["update_rel_l1_gap"] > max(r["eager_update_rel_l1_gap"], 1e-30) * 2:
        raise SystemExit(f"{label}: graph vs eager gap {r['update_rel_l1_gap']} exceeds the "
                         f"eager path's own {r['eager_update_rel_l1_gap']}")
    if extra_fetch and masks and not (r["mask_step1_equal"] and r["mask_step2_equal"]
                                      and r["mask_differs_between_steps"]):
        raise SystemExit(f"{label}: the dropout masks do not follow the counter: {r}")
    if extra_fetch and not masks and not r["extra_fetch_bit_equal"]:
        raise SystemExit(f"{label}: the fetched {extra_fetch} differ between graph and eager")
    if reference and not (all(r["reference_loss_bit_equal"]) and r["reference_state_differs"] == 0
                          and r["reference_extra_fetch_bit_equal"]):
        raise SystemExit(f"{label}: the eager reference path parts from the eager path: "
                         f"losses {r['reference_loss_bit_equal']}, "
                         f"{r['reference_state_differs']} state tensors")
    rf = r["run_fused"]
    if rf["counter_after"] != [FUSED_K, FUSED_K] or rf["shape"][0] != FUSED_K:
        raise SystemExit(f"{label}: run_fused's contract broken: {rf}")
    if deterministic and not (rf["losses_bit_equal"] and rf["state_differs"] == 0):
        raise SystemExit(f"{label}: run_fused differs from {FUSED_K} run calls: {rf}")
    return r


def phase_captured_training(torch):
    """Captured training steps: BERT-base at bench.py's configuration and
    ResNet-50 at bench.py's, graph executor against eager executor."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.tools.train_profile import (BATCH, LR, MASKS_PER_SEQ, SEQ,
                                                      build_pretrain, build_resnet50,
                                                      pretrain_feed)
    cfg = bert.BertConfig(dtype="bfloat16", dropout=ATTN_DROPOUT)
    main, startup, total, _ = build_pretrain(cfg, BATCH, SEQ, MASKS_PER_SEQ, LR, SEED)
    feed = pretrain_feed(np.random.RandomState(SEED), cfg, BATCH, SEQ, MASKS_PER_SEQ)
    feed = {k: torch.from_numpy(v).cuda() for k, v in feed.items()}
    drops = [op for op in main.global_block().ops
             if op.type == "dropout" and not op.attr("is_test", False)]
    expected = {"flash_attn_fwd": cfg.n_layers, "flash_attn_bwd": cfg.n_layers,
                "multi_tensor_update": 1, "dropout_fwd": len(drops)}
    bert_r = _captured_model(
        torch, pt, f"bert-base pretrain bf16 B{BATCH} S{SEQ} dropout {cfg.dropout} Adam({LR})",
        main, startup, feed, total, expected, [drops[0].output("Mask")[0]])
    del main, startup, feed
    torch.cuda.empty_cache()
    main, startup, loss, _, fused = build_resnet50()
    feed = _resnet_feed(torch, np.random.RandomState(SEED), RESNET_BATCH, "cuda")
    res_r = _captured_model(
        torch, pt, f"resnet50 NHWC s2d bf16 B{RESNET_BATCH} 224x224 Momentum(0.1, 0.9)",
        main, startup, feed, loss, {"fused_conv1x1_bn_fwd": fused, "multi_tensor_update": 1},
        [])
    if not (res_r["eager_deterministic"] and res_r["state_differs"] == 0
            and all(res_r["loss_bit_equal"]) and res_r["run_fused"]["losses_bit_equal"]):
        raise SystemExit("ResNet-50: graph and eager paths are not bit for bit")
    del main, startup, feed
    torch.cuda.empty_cache()
    return bert_r, res_r


# Transformer NMT (phase 13). Step 1 on the card against the CPU port, batch 2,
# dropout 0, f32 on both sides, from the same weights. The loss: both sum in f32
# in other orders (cuBLAS against the CPU's GEMMs, 512- and 2048-deep products
# over 12 layers, a 32000-wide log-sum-exp), about 1e-6 relative a sum; the loss
# is a mean over 128 positions, so 1e-4 relative bounds it with room. The update:
# Adam's first update is lr * g / (|g| + eps), so an element's update moves
# only where its gradient is near the f32 rounding of its sums (a sign flips, or
# |g| is near eps); 1e-2 of sum|u| allows 1% of the update's mass to move.
NMT_LOSS_REL, NMT_UPDATE_REL = 1e-4, 1e-2
NMT_CPU_BATCH = 2
# decode: beam 4, max_len 16 (beam_decode's default), 8 sentences of length 64
DECODE_BATCH, DECODE_BEAM, DECODE_MAX_LEN, DECODE_RUNS = 8, 4, 16, 4
# decode, card against the CPU port at batch 2. A score is a sum of up to 16
# log-probs of about -10, each from a 32000-wide log-softmax of logits that the
# two devices round apart by about 1e-5 (f32 sums in other orders through 6
# layers); 1e-3 absolute is 16 such steps with room (and ~60 f32 ulps at 166).
# Where the ids part, the search took another candidate on a near-tie: the CPU's
# smallest gap among its top K + 1 candidates at the first parting step must lie
# under the same 1e-3, else the parting is a fault, not rounding.
DECODE_SCORE_ATOL, DECODE_TIE_MARGIN = 1e-3, 1e-3
# beam 4's best score against greedy's: the JAX suite's slack
# (tests/test_beam_search.py::test_transformer_beam_beats_greedy_score)
BEAM_VS_GREEDY_SLACK = 1e-4


def _nmt_train(torch, pt):
    """Transformer training (phase 13, first part): graph against eager as
    phase 11, then step 1 against the CPU port at batch 2 on the dropout-0
    build of the same weights. Returns (result, the graph path's final
    state, launches)."""
    from paddle_tpu_torch.tools.train_profile import (NMT_BATCH, NMT_LR, NMT_SEQ,
                                                      build_transformer, nmt_feed,
                                                      transformer_config)
    cfg = transformer_config()
    t0 = time.perf_counter()
    main, startup, loss, params_grads = build_transformer(cfg, NMT_BATCH, NMT_SEQ, NMT_LR, SEED)
    build_s = time.perf_counter() - t0
    raw = nmt_feed(np.random.RandomState(SEED), cfg, NMT_BATCH, NMT_SEQ)
    feed = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    drops = [op for op in main.global_block().ops
             if op.type == "dropout" and not op.attr("is_test", False)]
    init = _startup_state(pt, main, startup)
    n_params = sum(int(np.prod(p.shape)) for p, _ in params_grads)
    expected = {"dropout_fwd": len(drops), "multi_tensor_update": 1}
    final = {}
    label = (f"transformer-base f32 B{NMT_BATCH} S{NMT_SEQ}+{NMT_SEQ} vocab "
             f"{cfg.src_vocab}/{cfg.trg_vocab} dropout {cfg.dropout} label smoothing 0.1 "
             f"Adam({NMT_LR})")
    t0 = time.perf_counter()
    r = _captured_model(torch, pt, label, main, startup, feed, loss, expected,
                        [drops[0].output("Mask")[0]], init=init, final=final)
    captured_s = time.perf_counter() - t0
    losses = r["losses"]["graph"]
    if not (r["eager_deterministic"] and r["state_differs"] == 0 and all(r["loss_bit_equal"])
            and r["run_fused"]["losses_bit_equal"] and r["run_fused"]["state_differs"] == 0):
        raise SystemExit("Transformer: graph and eager paths are not bit for bit")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"Transformer: the loss does not fall on one batch: {losses}")
    del main, startup, feed

    # step 1 against the CPU port: batch 2, the dropout-0 build, the same weights
    main0, _, loss0, pg0 = build_transformer(transformer_config(dropout=0.0), NMT_CPU_BATCH,
                                             NMT_SEQ, NMT_LR, SEED)
    state0 = {n for n, v in main0.global_block().vars.items() if v.persistable}
    if state0 != set(init):
        raise SystemExit(f"Transformer: the dropout-0 build names other state: "
                         f"{sorted(state0 ^ set(init))[:8]}")
    feed2 = {k: v[:NMT_CPU_BATCH] for k, v in raw.items()}
    params = [p.name for p, _ in pg0]
    card = _step_once(torch, pt, main0, loss0, params, init, feed2, "cuda")
    t0 = time.perf_counter()
    cpu = _step_once(torch, pt, main0, loss0, params, init, feed2, "cpu")
    cpu_s = time.perf_counter() - t0
    gaps = dict(_gaps(card, cpu), loss_rel_limit=NMT_LOSS_REL,
                update_rel_l1_limit=NMT_UPDATE_REL, cpu_seconds=cpu_s)
    del main0, init
    g = r["paths"]["graph"]
    ms = g["step_ms_median_warm"]
    summary = dict(model=label, params=n_params, build_s=build_s, captured_s=captured_s,
                   dropout_ops=len(drops),
                   step1_card_vs_cpu_batch2_dropout0=gaps,
                   step_ms={p: r["paths"][p]["step_ms_median_warm"] for p in r["paths"]},
                   tokens_per_s={p: 2 * NMT_BATCH * NMT_SEQ / r["paths"][p]["step_ms_median_warm"]
                                 * 1e3 for p in r["paths"]},
                   idle_share_unprofiled={p: r["paths"][p]["idle_share_unprofiled"]
                                          for p in r["paths"]},
                   graph_step_ms=ms)
    emit("transformer_train", **summary)
    if not (gaps["loss_rel_gap"] <= NMT_LOSS_REL and gaps["update_rel_l1_gap"] <= NMT_UPDATE_REL):
        raise SystemExit(f"Transformer step 1: card vs CPU {gaps} exceeds the limits")
    return dict(r, summary=summary), final, r["launches"]["graph"]


def _decode_runs(torch, pt, main, weights, feed, fetch, graphs, runs):
    """``runs`` decodes of one batch on a fresh executor (graphs or eager):
    (the last run's fetches as numpy, each run's wall ms, the executor's
    graph pools, the profile of PROFILED_STEPS more)."""
    from paddle_tpu_torch.tools.train_profile import profile_steps
    exe = pt.Executor()
    exe._use_graphs = graphs
    scope = pt.Scope()
    for n, t in weights.items():
        scope.set_var(n, t)
    times = []
    with pt.scope_guard(scope):
        for _ in range(runs):
            t0 = time.perf_counter()
            outs = exe.run(main, feed=feed, fetch_list=fetch)
            times.append((time.perf_counter() - t0) * 1e3)
        pools = _graph_pools(exe)
        prof = profile_steps(torch, exe, main, feed, fetch, PROFILED_STEPS)
    exe.close()
    return outs, times, pools, prof


def _first_parting(card, cpu):
    """The first decode step at which the card's and the CPU's per-step ids
    or parents ([B, T, K]) differ, and the rows that differ there; None when
    they agree."""
    (ci, cp), (pi, pp) = card, cpu
    for t in range(ci.shape[1]):
        rows = [b for b in range(ci.shape[0])
                if not (np.array_equal(ci[b, t], pi[b, t]) and np.array_equal(cp[b, t], pp[b, t]))]
        if rows:
            return t, rows
    return None


def _nmt_decode(torch, pt, final):
    """Transformer beam-search decode (phase 13, second part) on the weights
    the training part ends with, carried by name: graph against eager, the
    card against the CPU port at batch 2, beams best-first, beam 4 against
    greedy; decode ms, generated tokens/s, idle share, launches."""
    from paddle_tpu_torch.core import cuda_build, registry
    from paddle_tpu_torch.ops import beam_ops
    from paddle_tpu_torch.tools.train_profile import (NMT_SEQ, build_beam_decode,
                                                      decode_feed, transformer_config)
    cfg = transformer_config(dropout=0.0)
    t0 = time.perf_counter()
    main, _, ids, scores, scan = build_beam_decode(cfg, NMT_SEQ, DECODE_BEAM, DECODE_MAX_LEN,
                                                   SEED)
    build_s = time.perf_counter() - t0
    params = [n for n, v in main.global_block().vars.items() if v.persistable]
    missing = [n for n in params if n not in final]
    if missing:
        raise SystemExit(f"decode: parameters {missing[:8]} are not in the trained state")
    weights = {n: final[n] for n in params}
    raw = decode_feed(np.random.RandomState(SEED + 13), cfg, DECODE_BATCH, NMT_SEQ)
    feed = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    fetch = [ids, scores] + scan.output("Out")          # + per-step ids and parents

    t_start = time.perf_counter()
    res, launches = {}, {}
    for path in ("graph", "eager"):
        for fn in cuda_build.COUNTED:
            fn.launches = 0
        outs, times, pools, prof = _decode_runs(torch, pt, main, weights, feed, fetch,
                                                path == "graph", DECODE_RUNS)
        launches[path] = {fn.__name__: fn.launches for fn in cuda_build.COUNTED if fn.launches}
        warm = times[2:] if path == "graph" else times[1:]
        ms = statistics.median(warm)
        res[path] = dict(outs=outs, decode_ms=times, decode_ms_median_warm=ms,
                         generated_tokens_per_s=DECODE_BATCH * DECODE_MAX_LEN / ms * 1e3,
                         graph_pool_gb=pools, device_busy_ms=prof["device_busy_ms"],
                         idle_share_profiled=prof["device_idle_share"],
                         idle_share_unprofiled=max(0.0, 1 - prof["device_busy_ms"] / ms),
                         device_activities=prof["device_activities_per_step"],
                         by_kind=prof["by_kind"])
    g_ids, g_scores, g_steps, g_parents = res["graph"].pop("outs")
    e_ids, e_scores, _, _ = res["eager"].pop("outs")
    bit_equal = bool(np.array_equal(g_ids, e_ids) and np.array_equal(g_scores, e_scores))

    # greedy (beam 1) on the same weights, on the card
    gmain, _, gids, gscores, gscan = build_beam_decode(cfg, NMT_SEQ, 1, DECODE_MAX_LEN, SEED)
    scope = pt.Scope()
    for n, t in weights.items():
        scope.set_var(n, t)
    with pt.scope_guard(scope):
        greedy_ids, greedy_scores, greedy_steps = pt.Executor().run(
            gmain, feed=feed, fetch_list=[gids, gscores, gscan.output("Out")[0]])
    del scope, gmain

    # the CPU port at batch 2, recording each step's candidates
    cand = []
    d = registry.get("beam_search")
    lower = d.lower

    def recording(ctx, ins):
        flat = beam_ops.candidates(ins["PreScores"][0], ins["Scores"][0], ins["Finished"][0],
                                   ctx.attr("end_id", 1))
        cand.append(torch.sort(flat, dim=-1, descending=True).values[:, :DECODE_BEAM + 1])
        return lower(ctx, ins)

    feed2 = {k: v[:NMT_CPU_BATCH] for k, v in raw.items()}
    scope = pt.Scope()
    for n, t in weights.items():
        scope.set_var(n, t.cpu())
    d.lower = recording
    t0 = time.perf_counter()
    try:
        with pt.scope_guard(scope):
            c_ids, c_scores, c_steps, c_parents = pt.Executor(pt.CPUPlace()).run(
                main, feed=feed2, fetch_list=fetch)
    finally:
        d.lower = lower
    cpu_s = time.perf_counter() - t0
    del scope
    k2 = slice(0, NMT_CPU_BATCH)
    ids_equal = bool(np.array_equal(g_ids[k2], c_ids))
    cpu_check = dict(batch=NMT_CPU_BATCH, ids_equal=ids_equal, cpu_seconds=cpu_s,
                     score_atol=DECODE_SCORE_ATOL, tie_margin=DECODE_TIE_MARGIN)
    same_rows = [b for b in range(NMT_CPU_BATCH) if np.array_equal(g_ids[b], c_ids[b])]
    cpu_check["max_abs_score_gap_where_ids_equal"] = max(
        [float(np.abs(g_scores[b] - c_scores[b]).max()) for b in same_rows] or [0.0])
    parting = _first_parting((g_steps[k2], g_parents[k2]), (c_steps, c_parents))
    if parting is not None:
        t, rows = parting
        top = cand[t][rows].numpy()
        cpu_check.update(first_parting_step=t, parting_rows=rows,
                         cpu_top_k_gap=float((top[:, :-1] - top[:, 1:]).min()),
                         cpu_top_candidates=top.tolist())
    sorted_best_first = bool((g_scores[:, :-1] >= g_scores[:, 1:]).all())
    beam_vs_greedy = (g_scores[:, 0] - greedy_scores[:, 0]).tolist()
    # beam search promises a best score at least greedy's only where greedy's
    # sentence survives among the beams (a prefix of it can be pruned by K
    # better prefixes that then fall further): held there, reported everywhere
    greedy_in_beam = [bool((g_ids[b] == greedy_ids[b, 0]).all(-1).any())
                      for b in range(DECODE_BATCH)]
    # at step 0 only beam 0 is live: the beam's best first token is greedy's
    first_token_is_greedys = bool(np.array_equal(g_steps[:, 0, 0], greedy_steps[:, 0, 0]))
    beam_below_greedy = [b for b in range(DECODE_BATCH)
                         if greedy_in_beam[b] and beam_vs_greedy[b] < -BEAM_VS_GREEDY_SLACK]
    r = dict(model=(f"transformer-base beam_decode beam {DECODE_BEAM} max_len {DECODE_MAX_LEN} "
                    f"B{DECODE_BATCH} S{NMT_SEQ} ragged masks, weights after the training "
                    f"steps"), build_s=build_s, params=len(params),
             lengths=raw["mask"].sum(1).astype(int).tolist(),
             graph_vs_eager_bit_equal=bit_equal, launches=launches, paths=res,
             graph_speedup=res["eager"]["decode_ms_median_warm"]
             / res["graph"]["decode_ms_median_warm"],
             card_vs_cpu=cpu_check, sorted_best_first=sorted_best_first,
             beam4_minus_greedy_best=beam_vs_greedy, greedy_sentence_in_beams=greedy_in_beam,
             first_token_is_greedys=first_token_is_greedys,
             first_sentence=g_ids[0, 0].tolist(), best_scores=g_scores[:, 0].tolist(),
             seconds=time.perf_counter() - t_start)
    emit("transformer_decode", **r)
    if g_ids.shape != (DECODE_BATCH, DECODE_BEAM, DECODE_MAX_LEN) or \
            not np.isfinite(g_scores).all():
        raise SystemExit(f"decode: bad output {g_ids.shape}, finite={np.isfinite(g_scores).all()}")
    if not bit_equal:
        raise SystemExit("decode: the graph path's ids or scores differ from the eager path's")
    if not sorted_best_first or beam_below_greedy or not first_token_is_greedys:
        raise SystemExit(f"decode: beams not best-first ({sorted_best_first}), beam "
                         f"{DECODE_BEAM} below greedy with greedy's sentence among its beams "
                         f"(rows {beam_below_greedy}: {beam_vs_greedy}), or its best first "
                         f"token not greedy's ({first_token_is_greedys})")
    if cpu_check["max_abs_score_gap_where_ids_equal"] > DECODE_SCORE_ATOL:
        raise SystemExit(f"decode: scores part from the CPU port's: {cpu_check}")
    if not ids_equal and (parting is None or cpu_check["cpu_top_k_gap"] > DECODE_TIE_MARGIN):
        raise SystemExit(f"decode: ids part from the CPU port's without a near-tie: {cpu_check}")
    return r


def phase_transformer(torch):
    """Transformer NMT (phase 13): training at transformer-base, then
    beam-search decode on the trained weights."""
    import paddle_tpu_torch as pt
    train, final, launches = _nmt_train(torch, pt)
    torch.cuda.empty_cache()
    decode = _nmt_decode(torch, pt, final)
    del final
    torch.cuda.empty_cache()
    return train, decode, launches


# DeepFM and the MNIST MLP (phase 14). Step 1 on the card against the CPU port,
# f32 on both sides, from the same weights and batch: both sum in f32 in other
# orders (cuBLAS against the CPU's GEMMs over 429- to 784-deep products, the
# sums over fields and the batch mean), about 1e-6 relative a sum, so 1e-4
# relative bounds the loss with room. The update: Adam's first update is lr *
# g / (|g| + eps), SGD's lr * g; an element's update moves by the rounding of
# its gradient's sums (about 1e-6 relative), or by up to lr where Adam's
# gradient sign flips near 0; 1e-2 of sum|u| allows 1% of the update's mass.
CTR_LOSS_REL, CTR_UPDATE_REL = 1e-4, 1e-2
# the fetched AUC against the AUC that numpy computes, in float64, from the
# fetched probabilities' buckets: the card sums 4096 f32 trapezoids of f32
# rates (about 4096 * 2^-24 of the AUC at most); 1e-5 absolute bounds it.
# Against the exact rank statistic of the probabilities the histogram differs
# only in the pairs that share a bucket, each counted a half: that half of the
# share of such pairs is its resolution.
AUC_ATOL = 1e-5
# served DeepFM, card against the CPU Predictor: prob = sigmoid(logit) <= 1,
# the logit's f32 sums in other orders (about 1e-6 of its terms' size)
SERVE_PROB_ATOL = 1e-5
CTR_SERVE_BATCHES, CTR_SERVE_RUNS = (4096, 64), 10
# the MNIST MLP: steps of one batch over which the loss must fall
MNIST_FALL_STEPS = 20


def _auc_from_buckets(prob, label, nt=4095):
    """(the histogram AUC in float64 from the buckets of ``prob``, the exact
    rank statistic of ``prob``, the histogram's resolution: half the share
    of (positive, negative) pairs that fall in one bucket)."""
    p = prob.reshape(-1).astype(np.float32)
    pos = label.reshape(-1) > 0
    b = np.clip((p * np.float32(nt)).astype(np.int32), 0, nt)
    hp = np.bincount(b[pos], minlength=nt + 1).astype(np.float64)
    hn = np.bincount(b[~pos], minlength=nt + 1).astype(np.float64)
    tp, fp = np.cumsum(hp[::-1]), np.cumsum(hn[::-1])
    tpr, fpr = tp / max(tp[-1], 1), fp / max(fp[-1], 1)
    tpr0, fpr0 = np.concatenate([[0.0], tpr[:-1]]), np.concatenate([[0.0], fpr[:-1]])
    hist_auc = float(np.sum((fpr - fpr0) * (tpr + tpr0) / 2))
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    _, inv, counts = np.unique(p, return_inverse=True, return_counts=True)
    ranks = (np.cumsum(counts) - (counts - 1) / 2)[inv]     # 1-based, ties averaged
    rank_auc = float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))
    resolution = float(0.5 * (hp * hn).sum() / (n_pos * n_neg))
    return hist_auc, rank_auc, resolution


def _step1_vs_cpu(torch, pt, main, loss, params_grads, init, raw):
    """Step 1 from ``init`` on the card and on the CPU port, the same batch:
    the loss and update gaps, held to CTR_LOSS_REL and CTR_UPDATE_REL."""
    params = [p.name for p, _ in params_grads]
    feed_card = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    card = _step_once(torch, pt, main, loss, params, init, feed_card, "cuda")
    t0 = time.perf_counter()
    cpu = _step_once(torch, pt, main, loss, params, init, raw, "cpu")
    return dict(_gaps(card, cpu), loss_rel_limit=CTR_LOSS_REL,
                update_rel_l1_limit=CTR_UPDATE_REL, cpu_seconds=time.perf_counter() - t0)


def _deepfm_serve(torch, pt, workdir, main, prob, weights):
    """The trained DeepFM saved with ``save_inference_model`` (ids and dense
    fed, prob fetched), served by the Predictor on the card at B 4096 and
    B 64 through its CUDA graphs: bit-equal to its eager run, within
    SERVE_PROB_ATOL of the CPU Predictor; latency per request shape."""
    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.tools.train_profile import deepfm_feed
    model_dir = os.path.join(workdir, "deepfm")
    scope = pt.Scope()
    for n, t in weights.items():
        scope.set_var(n, t)
    with pt.scope_guard(scope):
        pt.io.save_inference_model(model_dir, ["ids", "dense"], [prob], None, main_program=main)
    del scope
    pred, eager = Predictor(model_dir), Predictor(model_dir)
    eager._use_graphs = False
    cpu = Predictor(model_dir, device="cpu")
    pruned = sorted({op.type for op in pred.program.global_block().ops})
    rng = np.random.RandomState(SEED + 5)
    shapes = []
    for batch in CTR_SERVE_BATCHES:
        raw = deepfm_feed(rng, batch)
        req = {"ids": raw["ids"], "dense": raw["dense"]}
        lat = {}
        outs = {}
        for name, p in (("graph", pred), ("eager", eager)):
            p.run(req)                       # first use: the capture (graph), the allocator
            times = []
            for _ in range(CTR_SERVE_RUNS):
                t0 = time.perf_counter()
                outs[name] = p.run(req)[0]
                times.append((time.perf_counter() - t0) * 1e3)
            lat[name] = statistics.median(times)
        c = cpu.run(req)[0]
        g = outs["graph"]
        shapes.append(dict(batch=batch, ms=lat, examples_per_s={k: batch / v * 1e3
                                                                for k, v in lat.items()},
                           graph_vs_eager_bit_equal=bool(np.array_equal(g, outs["eager"])),
                           card_vs_cpu_max_abs=float(np.abs(g - c).max()),
                           finite=bool(np.isfinite(g).all()), shape=list(g.shape),
                           prob_range=[float(g.min()), float(g.max())]))
    graphs = len(pred._compiled)
    pool_gb = [e.memory_bytes / 1e9 for e in pred._compiled.values()]
    del pred, eager, cpu
    r = dict(ops=pruned, requests=shapes, graphs=graphs, graph_pool_gb=pool_gb,
             prob_atol=SERVE_PROB_ATOL)
    emit("deepfm_serving", **r)
    for sh in shapes:
        if not (sh["finite"] and sh["shape"] == [sh["batch"], 1] and sh["graph_vs_eager_bit_equal"]
                and sh["card_vs_cpu_max_abs"] <= SERVE_PROB_ATOL):
            raise SystemExit(f"deepfm serving: {sh}")
    if {"auc", "sigmoid_cross_entropy_with_logits", "adam"} & set(pruned):
        raise SystemExit(f"deepfm serving: the saved program was not pruned: {pruned}")
    return r


def _deepfm(torch, pt, workdir):
    """DeepFM at bench_workloads.py's configuration (phase 14, first part)."""
    from paddle_tpu_torch.tools.train_profile import (CTR_BATCH, CTR_EMBED, CTR_FIELDS,
                                                      CTR_LR, CTR_VOCAB, build_deepfm,
                                                      deepfm_feed)
    t0 = time.perf_counter()
    main, startup, loss, auc, prob, pg = build_deepfm()
    build_s = time.perf_counter() - t0
    raw = deepfm_feed(np.random.RandomState(SEED))
    feed = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    init = _startup_state(pt, main, startup)
    hist = sorted(n for n in init if n.startswith("auc"))
    n_params = sum(int(np.prod(p.shape)) for p, _ in pg)
    label = (f"deepfm f32 B{CTR_BATCH} fields {CTR_FIELDS} vocab {CTR_VOCAB} embed {CTR_EMBED} "
             f"tower 400-400-400 auc(4095) Adam({CTR_LR})")
    final = {}
    t0 = time.perf_counter()
    r = _captured_model(torch, pt, label, main, startup, feed, loss, {"multi_tensor_update": 1},
                        [auc], init=init, final=final, masks=False, reference=True)
    captured_s = time.perf_counter() - t0
    if not (r["eager_deterministic"] and r["state_differs"] == 0 and all(r["loss_bit_equal"])
            and r["run_fused"]["losses_bit_equal"] and r["run_fused"]["state_differs"] == 0):
        raise SystemExit("DeepFM: graph and eager paths are not bit for bit")
    # the histograms hold every batch the graph path's state took (a capture
    # records and runs nothing: warm-up, capture + replay, 3 replays = 5 runs)
    counted = sum(float(final[n].double().sum()) for n in hist)

    # the fetched AUC of one step from the startup state against numpy's
    scope = pt.Scope()
    for n, t in init.items():
        scope.set_var(n, t.clone())
    with pt.scope_guard(scope):
        auc_v, prob_v = pt.Executor().run(main, feed=feed, fetch_list=[auc, prob])
    del scope
    hist_auc, rank_auc, resolution = _auc_from_buckets(prob_v, raw["label"])
    auc_check = dict(fetched=float(auc_v[0]), numpy_from_buckets=hist_auc, rank_statistic=rank_auc,
                     resolution=resolution, atol=AUC_ATOL)
    gaps = _step1_vs_cpu(torch, pt, main, loss, pg, init, raw)
    g = r["paths"]["graph"]
    summary = dict(model=label, params=n_params, state_tensors=len(init), build_s=build_s,
                   captured_s=captured_s, histograms=hist,
                   histogram_count=counted, histogram_count_expected=CAPTURED_STEPS * CTR_BATCH,
                   auc_check=auc_check, step1_card_vs_cpu=gaps,
                   step_ms={p: r["paths"][p]["step_ms_median_warm"] for p in r["paths"]},
                   examples_per_s={p: CTR_BATCH / r["paths"][p]["step_ms_median_warm"] * 1e3
                                   for p in r["paths"]},
                   idle_share_unprofiled={p: r["paths"][p]["idle_share_unprofiled"]
                                          for p in r["paths"]},
                   device_ms_by_kind=g["by_kind"], graph_step_ms=g["step_ms_median_warm"])
    emit("deepfm_train", **summary)
    if counted != CAPTURED_STEPS * CTR_BATCH:
        raise SystemExit(f"DeepFM: the histograms hold {counted} examples, expected "
                         f"{CAPTURED_STEPS * CTR_BATCH}")
    if not (abs(auc_check["fetched"] - hist_auc) <= AUC_ATOL
            and abs(auc_check["fetched"] - rank_auc) <= resolution + AUC_ATOL):
        raise SystemExit(f"DeepFM: the fetched AUC is off: {auc_check}")
    if not (gaps["loss_rel_gap"] <= CTR_LOSS_REL and gaps["update_rel_l1_gap"] <= CTR_UPDATE_REL):
        raise SystemExit(f"DeepFM step 1: card vs CPU {gaps} exceeds the limits")
    serve = _deepfm_serve(torch, pt, workdir, main, prob, final)
    del final, init
    return dict(r, summary=summary, serving=serve)


def _mnist(torch, pt):
    """The MNIST MLP with SGD (phase 14, second part), then the same MLP with
    global-norm clipping and L2 decay."""
    from paddle_tpu_torch.tools.train_profile import (MNIST_BATCH, MNIST_LR, build_mnist,
                                                      mnist_feed)
    main, startup, loss, acc, pg = build_mnist()
    raw = mnist_feed(np.random.RandomState(SEED))
    feed = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    init = _startup_state(pt, main, startup)
    label = f"mnist mlp 784-128-64-10 f32 B{MNIST_BATCH} SGD({MNIST_LR})"
    r = _captured_model(torch, pt, label, main, startup, feed, loss, {"multi_tensor_update": 1},
                        [acc], init=init, masks=False, reference=True)
    if not (r["eager_deterministic"] and r["state_differs"] == 0 and all(r["loss_bit_equal"])
            and r["run_fused"]["losses_bit_equal"] and r["run_fused"]["state_differs"] == 0):
        raise SystemExit("MNIST MLP: graph and eager paths are not bit for bit")
    exe = pt.Executor()
    outs, _, _ = _steps(pt, exe, main, feed, [loss], init, MNIST_FALL_STEPS)
    exe.close()
    fall = [float(o[0].reshape(-1)[0]) for o in outs]
    gaps = _step1_vs_cpu(torch, pt, main, loss, pg, init, raw)

    # the same MLP with GradientClipByGlobalNorm(1.0) and SGD(0.01, L2Decay(1e-4))
    cmain, cstartup, closs, cacc, cpg = build_mnist(clip_norm=1.0, l2=1e-4)
    cinit = _startup_state(pt, cmain, cstartup)
    types = [op.type for op in cmain.global_block().ops]
    clabel = label + " GradientClipByGlobalNorm(1.0) L2Decay(1e-4)"
    cr = _captured_model(torch, pt, clabel, cmain, cstartup, feed, closs,
                         {"multi_tensor_update": 1}, [cacc], init=cinit, masks=False)
    clip_gaps = _step1_vs_cpu(torch, pt, cmain, closs, cpg, cinit, raw)
    clipped = dict(model=clabel, squared_l2_norm_ops=types.count("squared_l2_norm"),
                   sgd_ops=types.count("sgd"), losses=cr["losses"]["graph"],
                   step_ms={p: cr["paths"][p]["step_ms_median_warm"] for p in cr["paths"]},
                   step1_card_vs_cpu=clip_gaps)
    summary = dict(model=label, sgd_ops=sum(op.type == "sgd" for op in main.global_block().ops),
                   loss_over_steps=fall, step1_card_vs_cpu=gaps,
                   step_ms={p: r["paths"][p]["step_ms_median_warm"] for p in r["paths"]},
                   examples_per_s={p: MNIST_BATCH / r["paths"][p]["step_ms_median_warm"] * 1e3
                                   for p in r["paths"]},
                   clipped=clipped)
    emit("mnist_train", **summary)
    if not fall[-1] < fall[0]:
        raise SystemExit(f"MNIST MLP: the loss does not fall over {MNIST_FALL_STEPS} steps: {fall}")
    for name, gp in (("MNIST MLP", gaps), ("clipped MNIST MLP", clip_gaps)):
        if not (gp["loss_rel_gap"] <= CTR_LOSS_REL and gp["update_rel_l1_gap"] <= CTR_UPDATE_REL):
            raise SystemExit(f"{name} step 1: card vs CPU {gp} exceeds the limits")
    if not (cr["eager_deterministic"] and cr["state_differs"] == 0 and all(cr["loss_bit_equal"])
            and cr["run_fused"]["losses_bit_equal"]):
        raise SystemExit("clipped MNIST MLP: graph and eager paths are not bit for bit")
    return dict(r, summary=summary)


def phase_ctr_mnist(torch, workdir):
    """DeepFM CTR and the MNIST MLP (phase 14)."""
    import paddle_tpu_torch as pt
    deepfm = _deepfm(torch, pt, workdir)
    torch.cuda.empty_cache()
    mnist = _mnist(torch, pt)
    torch.cuda.empty_cache()
    return deepfm, mnist


# DeepFM trained from MultiSlot files (phase 15): bench_workloads.py's end-to-end
# leg, no cut: 200,000 rows in 8 part files, B 4096, drop_last: 48 batches an epoch
E2E_ROWS, E2E_PARTS, E2E_THREADS, E2E_FUSE = 200_000, 8, 4, 4


#: (fields, vocab, rows, parts) -> the part files, written once a run: phases
#: 15, 20 and 21 read the same 200,000 rows (writing them takes ~8 s)
_CTR_PARTS: dict = {}


def _write_ctr_parts(fields, vocab, n_rows=E2E_ROWS, n_parts=E2E_PARTS):
    """The part files as ``bench_workloads.py::_deepfm_e2e_body`` writes them,
    from ``RandomState(SEED)``: 26 ids < 2^24, 13 dense features and a label
    a line, slots ``;``-separated. The first call of a run writes them into a
    directory of their own under ``build/`` (removed when the process
    exits); later calls with the same arguments get the same files, which
    their readers only read."""
    key = (fields, vocab, n_rows, n_parts)
    if key in _CTR_PARTS:
        return _CTR_PARTS[key]
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    d = tempfile.mkdtemp(prefix="ctr_parts_", dir=os.path.join(REPO, "build"))
    atexit.register(shutil.rmtree, d, True)
    rng = np.random.RandomState(SEED)
    paths = _CTR_PARTS[key] = []
    for p in range(n_parts):
        path = os.path.join(d, f"part-{p}.txt")
        paths.append(path)
        with open(path, "w") as f:
            for _ in range(n_rows // n_parts):
                ids = rng.randint(0, min(vocab, 1 << 24), fields)
                dense = rng.rand(13)
                lbl = rng.randint(0, 2)
                f.write(" ".join(map(str, ids)) + ";" + " ".join(f"{x:.4f}" for x in dense)
                        + ";" + str(lbl) + "\n")
    return paths


def _device_busy_ms(prof) -> float:
    """Device time a profile recorded (activities that carry no CPU time)."""
    total = 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0 and e.cpu_time_total == 0:
            total += us
    if total == 0:
        raise SystemExit("torch.profiler recorded no device activity: device busy time "
                         "not measured")
    return total / 1e3


def phase_deepfm_files(torch, workdir):
    """DeepFM trained from MultiSlot files (phase 15)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import native
    from paddle_tpu_torch.core import cuda_build
    from paddle_tpu_torch.core.executor import as_tensor
    from paddle_tpu_torch.ops import multi_tensor
    from paddle_tpu_torch.tools.train_profile import (CTR_BATCH, CTR_EMBED, CTR_FIELDS,
                                                      CTR_LR, CTR_VOCAB, build_deepfm, traced)
    from torch.profiler import ProfilerActivity
    if not native.available():
        raise SystemExit(f"the native slot parser did not build or load: {native.build_error}")
    t0 = time.perf_counter()
    paths = _write_ctr_parts(CTR_FIELDS, CTR_VOCAB)
    write_s = time.perf_counter() - t0
    text_mb = sum(os.path.getsize(p) for p in paths) / 1e6
    main, startup, loss, auc, prob, _ = build_deepfm()
    use_vars = [main.global_block().var(n) for n in ("ids", "dense", "label")]
    fetch = [loss, auc]

    def make_ds():
        ds = pt.DatasetFactory().create_dataset("QueueDataset")
        ds.set_batch_size(CTR_BATCH)
        ds.set_thread(E2E_THREADS)
        ds.set_use_var(use_vars)
        ds.set_filelist(paths)
        ds.drop_last = True
        return ds

    # parse-only epoch: the input pipeline's host cost
    before = native.parses
    t0 = time.perf_counter()
    batches = list(make_ds()._iter_batches())
    parse_s = time.perf_counter() - t0
    native_parses = native.parses - before
    t0 = time.perf_counter()                    # of which the C++ parser's calls
    for path in paths:
        native.parse_slot_file(path, len(use_vars), n_threads=E2E_THREADS)
    native_parse_s = time.perf_counter() - t0
    n_batches = len(batches)
    n_ex = sum(len(b["label"]) for b in batches)
    dev = torch.device("cuda")
    feed_copy = []
    for b in batches[:10]:                      # the run's copy of one batch to the card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _ = {k: as_tensor(v, dev) for k, v in b.items()}
        torch.cuda.synchronize()
        feed_copy.append((time.perf_counter() - t0) * 1e3)

    init = _startup_state(pt, main, startup)
    names = sorted(init)
    exe = pt.Executor()

    def fresh_scope():
        """A scope at ``init`` whose step is warmed and captured: two runs
        (the warm-up, the capture), then the state put back in place (the
        graph keeps the scope's tensors) and the counter back to 0."""
        scope = pt.Scope()
        for n, t in init.items():
            scope.set_var(n, t.clone())
        with pt.scope_guard(scope):
            for _ in range(2):
                exe.run(main, feed=batches[0], fetch_list=fetch, return_numpy=False)
        for n, t in init.items():
            scope.find_var(n).copy_(t)
        main._rng_run_counter = 0
        torch.cuda.synchronize()
        return scope

    def counted(fn):
        for f in cuda_build.COUNTED:
            f.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, multi_tensor.multi_tensor_update.launches

    epochs, states = {}, {}

    def serial():
        for b in make_ds()._iter_batches():
            last = exe.run(main, feed=b, fetch_list=fetch, return_numpy=False)
        return [t.cpu().numpy() for t in last]

    def compute_only():
        for b in batches:
            last = exe.run(main, feed=b, fetch_list=fetch, return_numpy=False)
        return [t.cpu().numpy() for t in last]

    legs = (("compute_only", compute_only), ("serial", serial),
            ("prefetch", lambda: exe.train_from_dataset(main, make_ds(), fetch_list=fetch)),
            ("fused", lambda: exe.train_from_dataset(main, make_ds(), fetch_list=fetch,
                                                     fuse_steps=E2E_FUSE)))
    for name, fn in legs:
        scope = fresh_scope()
        with pt.scope_guard(scope):
            last, seconds, launches = counted(fn)
        epochs[name] = dict(seconds=seconds, examples_per_s=n_ex / seconds,
                            multi_tensor_update_launches=launches,
                            last_loss=float(last[0].reshape(-1)[0]),
                            last_auc=float(last[1].reshape(-1)[0]),
                            counter_after=main._rng_run_counter)
        states[name] = {n: scope.find_var(n).clone() for n in names}
        if name == "prefetch":
            live = scope
        del scope
    differs = {name: len(_state_equal(torch, states[name], states["serial"]))
               for name in ("compute_only", "prefetch", "fused")}

    # the prefetch epoch under the profiler: device busy time
    scope = fresh_scope()
    with pt.scope_guard(scope), traced([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exe.train_from_dataset(main, make_ds(), fetch_list=fetch)
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
    del scope
    busy_ms = _device_busy_ms(prof)
    del prof

    # infer_from_dataset on the trained state: nothing changes, and its last
    # batch's prob is run(use_prune=True)'s
    with pt.scope_guard(live):
        before_infer = {n: live.find_var(n).clone() for n in names}
        t0 = time.perf_counter()
        infer_prob, = exe.infer_from_dataset(main, make_ds(), fetch_list=[prob])
        infer_s = time.perf_counter() - t0
        infer_changed = _state_equal(torch, {n: live.find_var(n) for n in names},
                                     before_infer)
        pruned_prob, = exe.run(main, feed=batches[-1], fetch_list=[prob], use_prune=True)
        ckpt = os.path.join(workdir, "persistables")
        t0 = time.perf_counter()
        saved_bytes = pt.io.save_persistables(exe, ckpt, main)
        save_s = time.perf_counter() - t0
    del before_infer

    # one step from the live scope and the same step after load_persistables
    # into a fresh scope
    steps = {}
    loaded = pt.Scope()
    with pt.scope_guard(loaded):
        t0 = time.perf_counter()
        pt.io.load_persistables(exe, ckpt, main)
        load_s = time.perf_counter() - t0
    counter = main._rng_run_counter
    for name, scope in (("live", live), ("loaded", loaded)):
        main._rng_run_counter = counter
        with pt.scope_guard(scope):
            out = exe.run(main, feed=batches[1], fetch_list=fetch, return_numpy=False)
        # a loaded variable the step only reads stays in the scope as a CPU tensor
        steps[name] = ([t.clone() for t in out],
                       {n: scope.find_var(n).to(dev).clone() for n in names})
    resume_fetch_equal = all(torch.equal(a, b) for a, b in zip(steps["live"][0],
                                                                 steps["loaded"][0]))
    resume_differs = len(_state_equal(torch, steps["loaded"][1], steps["live"][1]))
    exe.close()
    del live, loaded, steps, states, init

    pf = epochs["prefetch"]
    r = dict(model=(f"deepfm f32 B{CTR_BATCH} fields {CTR_FIELDS} vocab {CTR_VOCAB} embed "
                    f"{CTR_EMBED} tower 400-400-400 auc(4095) Adam({CTR_LR})"),
             files=len(paths), rows=E2E_ROWS, text_mb=text_mb, write_s=write_s,
             threads=E2E_THREADS, batches=n_batches, examples=n_ex,
             native_parses=native_parses, native_library=str(native.library_path().name),
             parse_only_s=parse_s, parse_examples_per_s=n_ex / parse_s,
             native_parse_s=native_parse_s,
             feed_copy_ms_median=statistics.median(feed_copy), epochs=epochs,
             state_differs_from_serial=differs, prefetch_profiled_s=profiled_s,
             prefetch_device_busy_ms=busy_ms,
             idle_share_unprofiled=max(0.0, 1 - busy_ms / (pf["seconds"] * 1e3)),
             idle_share_profiled=max(0.0, 1 - busy_ms / (profiled_s * 1e3)),
             device_busy_ms_per_step=busy_ms / n_batches,
             bound_by=("parse" if parse_s >= epochs["compute_only"]["seconds"] else "steps"),
             infer=dict(seconds=infer_s, examples_per_s=n_ex / infer_s,
                        state_changed=len(infer_changed),
                        prob_equals_pruned_run=bool(np.array_equal(infer_prob, pruned_prob)),
                        prob_shape=list(infer_prob.shape),
                        prob_finite=bool(np.isfinite(infer_prob).all())),
             persistables=dict(bytes=saved_bytes, save_s=save_s, load_s=load_s,
                               step_fetch_equal=resume_fetch_equal,
                               step_state_differs=resume_differs))
    emit("deepfm_from_files", **r)
    if native_parses != len(paths):
        raise SystemExit(f"deepfm from files: {native_parses} of {len(paths)} part files "
                         f"parsed natively")
    if n_batches != E2E_ROWS // CTR_BATCH:
        raise SystemExit(f"deepfm from files: {n_batches} batches, expected "
                         f"{E2E_ROWS // CTR_BATCH}")
    for name, e in epochs.items():
        if e["multi_tensor_update_launches"] != n_batches or e["counter_after"] != n_batches:
            raise SystemExit(f"deepfm from files, {name} epoch: {e}")
        if not np.isfinite(e["last_loss"]):
            raise SystemExit(f"deepfm from files, {name} epoch: loss not finite")
    if any(differs.values()):
        raise SystemExit(f"deepfm from files: epochs part from the serial loop: {differs}")
    inf = r["infer"]
    if not (inf["state_changed"] == 0 and inf["prob_equals_pruned_run"] and inf["prob_finite"]
            and inf["prob_shape"] == [CTR_BATCH, 1]):
        raise SystemExit(f"deepfm from files, infer_from_dataset: {inf}")
    if not (resume_fetch_equal and resume_differs == 0):
        raise SystemExit(f"deepfm from files: the step after load_persistables differs "
                         f"from the live one: {r['persistables']}")
    return r


# The book chapters and VGG-16 (phase 16). Each chapter trains at its example's
# configuration and schedule (tools/book.py). The first BOOK_HELD_STEPS steps,
# graph against eager, are held bit for bit (losses, the fetched metric, every
# state tensor). Step 1 on the card against the CPU port from the same weights
# and batch: the loss gap relative to the loss, both summing in f32 in other
# orders (cuBLAS / cuDNN against the CPU's kernels, through up to 96 LSTM steps
# or 13 convolutions), about 1e-6 relative, so 1e-4 bounds it with room; the
# update as sum|u_card - u_cpu| / sum|u_cpu|: Adam's first update is
# lr * g / (|g| + eps), so an element moves only where its gradient is near its
# rounding error (a conv bias before a batch norm has a gradient of exactly 0
# in exact arithmetic, and flips by 2 lr), 1e-2 of the mass (NMT's limit).
BOOK_HELD_STEPS = 4
# steps traced for the device's busy time and activities (their mean): a trace
# of one short replay has come back empty from torch.profiler once
BOOK_PROFILED_STEPS = 3
BOOK_LOSS_REL, BOOK_UPDATE_REL = 1e-4, 1e-2
# VGG-16 step 1 on the CPU port at batch 8 (a CPU step at B 128 takes minutes)
BOOK_IMG_CPU_BATCH = 8
# VGG-16 served at bench_inference.py's shape: 3 x 224 x 224, mb 1 and 32
VGG_HW, VGG_BATCHES, VGG_RUNS = 224, (1, 32), 10
# the card's f32 logits against the CPU port's at mb 1: f32 sums of up to
# 4608 products (3 x 3 x 512) in other orders through 16 layers, about 1e-6 of
# the largest logit; 1e-3 of max|logit| bounds it with room
VGG_CPU_REL = 1e-3
# the bf16 build's logits against the f32 build's, same weights (bf16 values)
# and images, relative L2: each of the 16 layers (13 conv, 3 fc) rounds to bf16
# twice where f32 does not, its product and its bias add (unit roundoff 2^-9,
# relative; cuDNN and cuBLAS sum the products in f32 in both builds; ReLU and
# max pool are exact); a relative error that each layer carries on adds at most
# 32 * 2^-9 = 2^-4. A wrong bf16 convolution or fc gives O(1).
VGG_BF16_REL = 2 ** -4
# each example's own assert on its final metric (examples/*.py): chapter ->
# (metric, the bar, whether the metric must lie below it)
BOOK_BARS = {"fit_a_line": ("final_mse", 30.0, True),
             "understand_sentiment": ("test_accuracy", 0.8, False),
             "label_semantic_roles": ("viterbi_token_accuracy", 0.9, False),
             "recommender_system": ("test_mse_over_baseline", 0.7, True)}


def _book_chapters(pt, ds):
    """(chapter, training feeds, fetch of a training step, evaluate(exe,
    losses) -> metrics, batch of the CPU step) for each chapter, at the example's
    configuration, read from the port's loaders ``ds``."""
    from paddle_tpu_torch.models import transformer, vgg
    from paddle_tpu_torch.tools import book
    out = []

    ch = book.build_mnist_mlp(pt)
    feeds, test = book.mnist_feeds(ds)

    def mnist_eval(exe, losses, ch=ch, test=test):
        a, = exe.run(ch.test, feed=test, fetch_list=[ch.metric])
        return {"test_accuracy": float(np.asarray(a).reshape(-1)[0])}
    out.append((ch, feeds, [ch.loss], mnist_eval, None))

    ch = book.build_fit_a_line(pt)
    feeds = book.fit_a_line_feeds(ds)
    per_epoch = len(feeds) // book.FIT_EPOCHS
    out.append((ch, feeds, [ch.loss], lambda exe, losses, n=per_epoch: {
        "final_mse": float(np.mean(losses[-n:]))}, None))

    ch = book.build_word2vec(pt)
    out.append((ch, book.word2vec_feeds(), [ch.loss], lambda exe, losses: {
        "first_loss": losses[0], "last_loss": losses[-1]}, None))

    vocab, feeds, test = book.sentiment_feeds(ds)
    ch = book.build_understand_sentiment(pt, vocab)

    def sentiment_eval(exe, losses, ch=ch, test=test):
        accs = [float(np.asarray(exe.run(ch.main, feed=f, fetch_list=[ch.loss, ch.metric],
                                         use_prune=True)[1]).reshape(-1)[0]) for f in test]
        return {"test_accuracy": float(np.mean(accs)), "vocab": vocab}
    out.append((ch, feeds, ch.fetch, sentiment_eval, None))

    sizes, feeds = book.srl_feeds(ds)
    ch = book.build_label_semantic_roles(pt, *sizes)

    def srl_eval(exe, losses, ch=ch, first=feeds[0]):
        path, = exe.run(ch.main, feed=first, fetch_list=[ch.metric], use_prune=True)
        return {"viterbi_token_accuracy": book.viterbi_accuracy(path, first)}
    out.append((ch, feeds, [ch.loss], srl_eval, None))

    sizes, feeds, test = book.recommender_feeds(ds)
    ch = book.build_recommender_system(pt, *sizes)

    def rec_eval(exe, losses, ch=ch, test=test):
        mse = [float(np.asarray(exe.run(ch.main, feed=f, fetch_list=[ch.loss],
                                        use_prune=True)[0]).reshape(-1)[0]) for f in test]
        var = float(np.var(np.concatenate([f["rating"] for f in test])))
        return {"test_mse": float(np.mean(mse)), "predict_mean_baseline": var,
                "test_mse_over_baseline": float(np.mean(mse)) / var}
    out.append((ch, feeds, [ch.loss], rec_eval, None))

    ch = book.build_machine_translation(pt, transformer)
    out.append((ch, book.machine_translation_feeds(ds), [ch.loss], lambda exe, losses: {
        "first_loss": losses[0], "final_loss": losses[-1]}, None))

    ch = book.build_image_classification(pt, vgg)
    out.append((ch, book.image_classification_feeds(ds), ch.fetch, lambda exe, losses: {
        "final_loss": losses[-1]}, BOOK_IMG_CPU_BATCH))
    return out


def _on_card(torch, feed):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in feed.items()}


def _book_chapter(torch, pt, ch, feeds, fetch, evaluate, cpu_batch):
    """One chapter on the card: the held steps graph against eager, step 1
    against the CPU port, the example's schedule on the graph executor (step
    ms, losses, peak memory, graph pool), the final metric, the eager step ms
    and three profiled steps."""
    from paddle_tpu_torch.core import cuda_build
    from paddle_tpu_torch.tools.train_profile import profile_steps
    main = ch.main
    init = _startup_state(pt, main, ch.startup)
    drops = sum(op.type == "dropout" and not op.attr("is_test", False)
                for op in main.global_block().ops)
    expected = {"multi_tensor_update": 1, **({"dropout_fwd": drops} if drops else {})}
    held, launches, eager_ms = {}, {}, []
    for path in ("graph", "eager"):
        exe = pt.Executor()
        exe._use_graphs = path == "graph"
        for fn in cuda_build.COUNTED:
            fn.launches = 0
        scope = pt.Scope()
        for n, t in init.items():
            scope.set_var(n, t.clone())
        main._rng_run_counter = 0
        outs = []
        with pt.scope_guard(scope):
            for f in feeds[:BOOK_HELD_STEPS]:
                t0 = time.perf_counter()
                outs.append(exe.run(main, feed=f, fetch_list=ch.fetch, return_numpy=False))
                torch.cuda.synchronize()
                if path == "eager":
                    eager_ms.append((time.perf_counter() - t0) * 1e3)
        launches[path] = {fn.__name__: fn.launches for fn in cuda_build.COUNTED if fn.launches}
        held[path] = (outs, {n: scope.find_var(n).clone() for n in init})
        exe.close()
        del exe, scope
    (g_outs, g_state), (e_outs, e_state) = held["graph"], held["eager"]
    fetch_equal = all(torch.equal(a, b) for x, y in zip(g_outs, e_outs) for a, b in zip(x, y))
    state_differs = _state_equal(torch, g_state, e_state)
    del held, g_outs, e_outs, g_state, e_state

    params = [n for n, v in main.global_block().vars.items()
              if isinstance(v, pt.Parameter) and v.trainable]
    raw = feeds[0] if cpu_batch is None else {k: v[:cpu_batch] for k, v in feeds[0].items()}
    card = _step_once(torch, pt, main, ch.loss, params, init, _on_card(torch, raw), "cuda")
    t0 = time.perf_counter()
    cpu = _step_once(torch, pt, main, ch.loss, params, init, raw, "cpu")
    step1 = dict(_gaps(card, cpu), batch=int(next(iter(raw.values())).shape[0]),
                 cpu_seconds=time.perf_counter() - t0)
    del card, cpu

    # the example's schedule on the graph executor, from the same state
    exe = pt.Executor()
    scope = pt.Scope()
    for n, t in init.items():
        scope.set_var(n, t.clone())
    main._rng_run_counter = 0
    for fn in cuda_build.COUNTED:
        fn.launches = 0
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    t_all = time.perf_counter()
    with pt.scope_guard(scope):
        for f in feeds:
            t0 = time.perf_counter()
            out = exe.run(main, feed=f, fetch_list=fetch)
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
        train_s = time.perf_counter() - t_all
        train_launches = {fn.__name__: fn.launches for fn in cuda_build.COUNTED if fn.launches}
        peak = torch.cuda.max_memory_allocated() / 1e9
        pools = _graph_pools(exe)
        metrics = evaluate(exe, losses)
        prof = profile_steps(torch, exe, main, feeds[-1], fetch, BOOK_PROFILED_STEPS)
    exe.close()
    del exe, scope
    n = max(1, len(losses) // 10)
    r = dict(chapter=ch.name, steps=len(feeds), batch=int(next(iter(feeds[0].values())).shape[0]),
             parameters=int(sum(t.numel() for n_, t in init.items() if n_ in params)),
             held_steps=BOOK_HELD_STEPS, held_fetch_bit_equal=fetch_equal,
             held_state_differs=len(state_differs), held_state_differs_first=state_differs[:8],
             launches_held=launches, expected_launches_per_step=expected,
             step1_card_vs_cpu=dict(step1, loss_rel_limit=BOOK_LOSS_REL,
                                    update_rel_l1_limit=BOOK_UPDATE_REL),
             loss_first=losses[:3], loss_last=losses[-3:],
             loss_mean_first_tenth=float(np.mean(losses[:n])),
             loss_mean_last_tenth=float(np.mean(losses[-n:])),
             metrics=metrics, train_seconds=train_s, train_launches=train_launches,
             step_ms={"graph": statistics.median(times[2:]),
                      "eager": statistics.median(eager_ms[1:])},
             peak_gb=peak, graph_pool_gb=pools,
             profiled_step=dict(wall_ms=prof["wall_ms"], device_busy_ms=prof["device_busy_ms"],
                                idle_share=prof["device_idle_share"],
                                device_activities=prof["device_activities_per_step"],
                                by_kind=prof["by_kind"]))
    emit("book_chapter", **r)
    # the window's device records by name: what a trace late in a full run drops
    # is read against a run of this phase alone (ROADMAP fault 3.2)
    emit("book_trace_records", chapter=ch.name, steps=BOOK_PROFILED_STEPS,
         records=prof["device_records"])

    per_held = {k: v * BOOK_HELD_STEPS for k, v in expected.items()}
    for path in ("graph", "eager"):
        got = {k: launches[path].get(k, 0) for k in per_held}
        if got != per_held:
            raise SystemExit(f"{ch.name}: launches on the {path} path {got}, expected {per_held}")
    want = {k: v * len(feeds) for k, v in expected.items()}
    if {k: train_launches.get(k, 0) for k in want} != want:
        raise SystemExit(f"{ch.name}: launches over the schedule {train_launches}, expected {want}")
    if not (fetch_equal and not state_differs):
        raise SystemExit(f"{ch.name}: graph and eager part over the first {BOOK_HELD_STEPS} "
                         f"steps (fetches equal {fetch_equal}, state differs {state_differs[:8]})")
    if not (step1["loss_rel_gap"] <= BOOK_LOSS_REL and step1["update_rel_l1_gap"] <= BOOK_UPDATE_REL):
        raise SystemExit(f"{ch.name} step 1: card vs CPU {step1} exceeds the limits")
    if not (np.all(np.isfinite(losses)) and r["loss_mean_last_tenth"] < r["loss_mean_first_tenth"]):
        raise SystemExit(f"{ch.name}: the loss is not finite or does not fall: "
                         f"{r['loss_mean_first_tenth']} -> {r['loss_mean_last_tenth']}")
    bar = BOOK_BARS.get(ch.name)
    if bar is not None:
        value = metrics[bar[0]]
        if not (value < bar[1] if bar[2] else value > bar[1]):
            raise SystemExit(f"{ch.name}: {bar[0]} {value} misses the example's bar {bar[1]}")
    return r


def _viterbi_ties_on_card(torch):
    """crf_decoding over a zero transition matrix and zero emissions (every
    path ties) on the card and on the CPU: tag 0 everywhere on both, as
    ``jnp.argmax``'s first maximum gives."""
    from paddle_tpu_torch.core import registry
    lens = torch.tensor([1, 20, 7, 13], dtype=torch.int64)
    ins = {"Emission": [torch.zeros(4, 20, 6)], "Transition": [torch.zeros(8, 6)],
           "Length": [lens]}
    lower = registry.get("crf_decoding").lower
    cpu = lower(registry.LowerCtx({}), ins)["ViterbiPath"][0]
    card = lower(registry.LowerCtx({}, device="cuda"),
                 {k: [t.cuda() for t in v] for k, v in ins.items()})["ViterbiPath"][0].cpu()
    return bool(torch.equal(card, cpu) and not card.any())


def _vgg_models(torch, pt, workdir):
    """VGG-16 (1000 classes, ``is_test``) at 3 x VGG_HW x VGG_HW in f32 and in
    bf16 (``fluid.data("img", ..., dtype)`` as bench_inference.py builds it),
    saved with one set of weights: the f32 startup's draw rounded to bf16, so
    that the two builds differ only in the arithmetic. dtype -> model dir."""
    from paddle_tpu_torch.models import vgg
    progs = {}
    for dtype in ("float32", "bfloat16"):
        main, startup = pt.Program(), pt.Program()
        main.random_seed = startup.random_seed = SEED
        with pt.unique_name.guard(), pt.program_guard(main, startup):
            img = pt.data("img", [3, VGG_HW, VGG_HW], dtype)
            progs[dtype] = (main, startup, vgg.vgg16(img, None, is_test=True))
    shared = {n: t.to(torch.bfloat16)
              for n, t in _startup_state(pt, *progs["float32"][:2]).items()}
    dirs = {}
    for dtype, (main, startup, logits) in progs.items():
        exe, scope = pt.Executor(), pt.Scope()
        with pt.scope_guard(scope):
            exe.run(startup)
            names = {n for n, v in main.global_block().vars.items() if v.persistable}
            if names != set(shared):
                raise SystemExit(f"vgg16 {dtype}: parameters {sorted(names ^ set(shared))} "
                                 f"are not in both builds")
            for n, t in shared.items():
                scope.set_var(n, t.to(scope.find_var(n).dtype))
            dirs[dtype] = os.path.join(workdir, f"vgg16_{dtype}")
            pt.io.save_inference_model(dirs[dtype], ["img"], [logits], exe, main_program=main)
        exe.close()
    return dirs


def _serve_ms(pred, req):
    """Median latency of VGG_RUNS calls after the first (the capture on the
    graph path, cuDNN's plans), and the last output."""
    pred.run(req)
    times = []
    for _ in range(VGG_RUNS):
        t0 = time.perf_counter()
        out = pred.run(req)[0]
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def _vgg_serve(torch, pt, workdir):
    """VGG-16 served by the Predictor at mb 1 and 32, f32 and bf16, each fed
    the same images as a tensor already on the card (so that no host copy
    sits in either timed window): graph and eager latency (median of
    VGG_RUNS), the graph pools, graph against eager bit for bit, f32 mb 1
    against the CPU Predictor, bf16 against f32 from the same weights and
    images; and at mb 32 the latency with ``cudnn.deterministic`` off, the
    flag that ``resolve_device`` sets for the training steps' sake."""
    from paddle_tpu_torch.inference import Predictor
    dirs = _vgg_models(torch, pt, workdir)
    rng = np.random.RandomState(SEED + 16)
    # rounded to bf16 once: both builds read the same values
    images = {b: torch.from_numpy(rng.rand(b, 3, VGG_HW, VGG_HW).astype("float32"))
              .to("cuda", torch.bfloat16) for b in VGG_BATCHES}
    rows, graph_out = [], {}
    for dtype, model_dir in dirs.items():
        pred, eager = Predictor(model_dir), Predictor(model_dir)
        eager._use_graphs = False
        n_params = sum(int(np.prod(v.shape)) for v in pred._state.values())
        for batch in VGG_BATCHES:
            req = {"img": images[batch].to(getattr(torch, dtype))}
            lat, outs = {}, {}
            for name, p in (("graph", pred), ("eager", eager)):
                lat[name], outs[name] = _serve_ms(p, req)
            g = outs["graph"]
            row = dict(dtype=dtype, batch=batch, params=n_params, feed="card tensor", ms=lat,
                       images_per_s={k: batch / v * 1e3 for k, v in lat.items()},
                       graph_vs_eager_bit_equal=bool(np.array_equal(g, outs["eager"])),
                       finite=bool(np.isfinite(g).all()), shape=list(g.shape))
            graph_out[dtype, batch] = g
            if dtype == "float32" and batch == 1:
                t0 = time.perf_counter()
                c = Predictor(model_dir, device="cpu").run({"img": req["img"].cpu().numpy()})[0]
                row.update(card_vs_cpu_max_abs=float(np.abs(g - c).max()),
                           cpu_max_abs_logit=float(np.abs(c).max()),
                           cpu_seconds=time.perf_counter() - t0)
            elif dtype == "bfloat16":
                f = graph_out["float32", batch]
                row.update(bf16_vs_f32_rel_l2=float(np.linalg.norm(g - f) / np.linalg.norm(f)),
                           bf16_vs_f32_max_abs=float(np.abs(g - f).max()),
                           f32_max_abs_logit=float(np.abs(f).max()),
                           bf16_vs_f32_rel_l2_limit=VGG_BF16_REL)
            rows.append(row)
        pools = [e.memory_bytes / 1e9 for e in pred._compiled.values()]
        for row in rows:
            if row["dtype"] == dtype:
                row["graph_pools_gb"] = pools
        del pred, eager
        torch.cuda.empty_cache()
        # the same requests at the largest batch with cuDNN free to pick any
        # algorithm (the constructors set the flag; it is cleared after them,
        # before the capture)
        batch = max(VGG_BATCHES)
        req = {"img": images[batch].to(getattr(torch, dtype))}
        pred, eager = Predictor(model_dir), Predictor(model_dir)
        eager._use_graphs = False
        torch.backends.cudnn.deterministic = False
        try:
            off = {name: _serve_ms(p, req) for name, p in (("graph", pred), ("eager", eager))}
        finally:
            torch.backends.cudnn.deterministic = True
        row = next(r for r in rows if r["dtype"] == dtype and r["batch"] == batch)
        row["ms_cudnn_nondeterministic"] = {k: v[0] for k, v in off.items()}
        row["cudnn_nondeterministic_bit_equal"] = bool(
            np.array_equal(off["graph"][1], graph_out[dtype, batch]))
        del pred, eager, off
        shutil.rmtree(model_dir, ignore_errors=True)
        torch.cuda.empty_cache()
    for row in rows:
        emit("vgg16_serving", **row)
    for row in rows:
        if not (row["finite"] and row["shape"] == [row["batch"], 1000]
                and row["graph_vs_eager_bit_equal"]):
            raise SystemExit(f"vgg16 serving: {row}")
        if "card_vs_cpu_max_abs" in row and not (
                row["card_vs_cpu_max_abs"] <= VGG_CPU_REL * row["cpu_max_abs_logit"]):
            raise SystemExit(f"vgg16 serving: card vs CPU {row}")
        if "bf16_vs_f32_rel_l2" in row and not row["bf16_vs_f32_rel_l2"] <= VGG_BF16_REL:
            raise SystemExit(f"vgg16 serving: bf16 vs f32 {row}")
    return rows


def _update_kind(program):
    """The one optimizer op type of ``program`` that ``multi_tensor_update``
    groups."""
    from paddle_tpu_torch.ops.multi_tensor import GROUPED
    kinds = {op.type for op in program.global_block().ops} & set(GROUPED)
    if len(kinds) != 1:
        raise SystemExit(f"expected one optimizer op type, found {sorted(kinds)}")
    return kinds.pop()


def book_setup(pt, workdir):
    """``_book_chapters`` read from the port's loaders pointed at a fresh,
    empty directory under ``workdir``, so that they serve their surrogates."""
    data_home = tempfile.mkdtemp(prefix="data_home_", dir=workdir)
    before = os.environ.get("PADDLE_TPU_DATA_HOME")
    os.environ["PADDLE_TPU_DATA_HOME"] = data_home
    try:
        from paddle_tpu_torch import dataset as ds
        ds.movielens._CACHE = None
        ds.conll05._real_cache.clear()
        return _book_chapters(pt, ds)
    finally:
        if before is None:
            os.environ.pop("PADDLE_TPU_DATA_HOME", None)
        else:
            os.environ["PADDLE_TPU_DATA_HOME"] = before


def book_update_lists(chapters):
    """(chapter, main program, update kind) of each chapter, for phase 9."""
    return [(ch.name, ch.main, _update_kind(ch.main)) for ch, *_ in chapters]


def phase_book(torch, chapters, workdir):
    """The book chapters (``book_setup``) and VGG-16 (phase 16)."""
    import paddle_tpu_torch as pt
    results = []
    for ch, feeds, fetch, evaluate, cpu_batch in chapters:
        results.append(_book_chapter(torch, pt, ch, feeds, fetch, evaluate, cpu_batch))
        torch.cuda.empty_cache()
    ties = _viterbi_ties_on_card(torch)
    emit("viterbi_ties", card_equals_cpu_tag0=ties)
    if not ties:
        raise SystemExit("crf_decoding: the card breaks Viterbi ties otherwise than the CPU")
    serving = _vgg_serve(torch, pt, workdir)
    return results, serving


# Phase 17: training under a learning-rate schedule, and the dense op cases on the card.
#: steps of each path (eager, graph, run_fused), each from the same preset counter
SCHED_STEPS = FUSED_K
#: the step counter before the first step. BERT's nested schedule advances it by 2
#: a run and its warmup (10,000 steps) reads counter + 2, so the four steps read
#: 9996, 9998 (warmup), 10000, 10002 (decay); noam reads counter + 1: 3998 to 4001,
#: across its peak at 4000
BERT_COUNTER0, NOAM_COUNTER0 = 9994, 3997
# The fetched learning rate against its float64 closed form (train_profile's
# bert_schedule_lr, noam_schedule_lr). The card computes it in f32 through at
# most five roundings (the counter's cast is exact; a divide or a product by a
# rounded constant, 1 - x, a power, a scale), each within 2^-24 of the value,
# and powf within 2 ulps: 1e-6 relative (about 16 f32 ulps) bounds it.
SCHED_LR_REL = 1e-6
LR_COUNTER = "@LR_DECAY_COUNTER@"


def _lr_var(main):
    """The learning-rate variable the update ops read."""
    return next(op for op in main.global_block().ops
                if op.type in ("adam", "lamb", "momentum", "lars_momentum", "sgd")
                ).input("LearningRate")[0]


def _scheduled_model(torch, pt, label, main, startup, feed, loss, expected, counter0,
                     per_run, closed_form, constant, init=None, final=None,
                     event="scheduled_training", fused=True):
    """One model under a schedule: SCHED_STEPS steps on the eager executor,
    on the graph executor (warm-up, capture, replays) and (``fused``) in one
    ``run_fused`` call, each from the startup state (or ``init``) with the
    counter at ``counter0``: the learning rate, the counter and the loss of
    every step and every state tensor, bit for bit across the three; the
    learning rate against ``closed_form(counter before the step)``; the
    counter advancing ``per_run`` a run; the launches of each path; the
    multi-tensor work tables each path built. Then the graph and eager step
    timed and profiled beside ``constant`` (the constant-LR program's timed
    paths, measured earlier in this call). ``counter0`` None: a constant
    learning rate (no counter; the learning rate is still fetched and held
    across the paths). ``final``, a dict, receives the eager path's state
    after its steps."""
    from paddle_tpu_torch.core import cuda_build
    from paddle_tpu_torch.ops import multi_tensor
    init = dict(init) if init is not None else _startup_state(pt, main, startup)
    fetch = [loss, _lr_var(main)]
    if counter0 is not None:
        init[LR_COUNTER] = torch.full((1,), counter0, dtype=torch.int64, device="cuda")
        fetch.append(LR_COUNTER)
    runs, launches, tables = {}, {}, {}
    for path in ("eager", "graph") + (("fused",) if fused else ()):
        exe = pt.Executor()
        exe._use_graphs = path != "eager"
        for fn in cuda_build.COUNTED:
            fn.launches = 0
        built = multi_tensor.tables_built
        scope = pt.Scope()
        for n, t in init.items():
            scope.set_var(n, t.clone())
        main._rng_run_counter = 0
        with pt.scope_guard(scope):
            if path == "fused":
                stacked = exe.run_fused(main, feeds=[feed] * SCHED_STEPS, fetch_list=fetch)
                outs = [[f[i].clone() for f in stacked] for i in range(SCHED_STEPS)]
            else:
                outs = [[f.clone() for f in exe.run(main, feed=feed, fetch_list=fetch,
                                                    return_numpy=False)]
                        for _ in range(SCHED_STEPS)]
        torch.cuda.synchronize()
        launches[path] = {fn.__name__: fn.launches for fn in cuda_build.COUNTED if fn.launches}
        tables[path] = multi_tensor.tables_built - built
        runs[path] = (outs, {n: scope.find_var(n).clone() for n in init})
        exe.close()
        del exe, scope
    (e_outs, e_state) = runs["eager"]
    if final is not None:
        final.update(e_state)
    lrs = {p: [float(o[1].reshape(-1)[0]) for o in runs[p][0]] for p in runs}
    losses = {p: [float(o[0].float().reshape(-1)[0]) for o in runs[p][0]] for p in runs}
    if counter0 is not None:
        counters = {p: [int(o[2].reshape(-1)[0]) for o in runs[p][0]] for p in runs}
        want_counters = [counter0 + per_run * (i + 1) for i in range(SCHED_STEPS)]
        closed = [closed_form(counter0 + per_run * i) for i in range(SCHED_STEPS)]
        lr_rel = max(abs(a - b) / abs(b) for a, b in zip(lrs["graph"], closed))
        final_counter = {p: int(runs[p][1][LR_COUNTER].reshape(-1)[0]) for p in runs}
    else:
        counters = want_counters = closed = lr_rel = final_counter = None
    across = {p: dict(lr_bit_equal=all(torch.equal(a[1], b[1]) for a, b in zip(runs[p][0], e_outs)),
                      loss_bit_equal=all(torch.equal(a[0], b[0])
                                         for a, b in zip(runs[p][0], e_outs)),
                      state_differs=len(_state_equal(torch, runs[p][1], e_state)))
              for p in runs if p != "eager"}
    del runs, e_outs, e_state
    paths = {("graph" if g else "eager"): _timed_path(torch, pt, main, feed, loss, init, g, True)
             for g in (True, False)}
    r = dict(model=label, steps=SCHED_STEPS, counter0=counter0, counter_per_run=per_run,
             lr=lrs, lr_closed_form=closed, lr_rel_gap=lr_rel, lr_rel_limit=SCHED_LR_REL,
             counters=counters, expected_counters=want_counters, final_counter=final_counter,
             losses=losses, across_paths=across, launches=launches,
             expected_launches_per_step=expected, work_tables_built=tables,
             step_ms={p: paths[p]["step_ms_median_warm"] for p in paths},
             constant_lr_step_ms={p: constant[p]["step_ms_median_warm"] for p in constant},
             device_busy_ms={p: paths[p]["device_busy_ms"] for p in paths},
             constant_lr_device_busy_ms={p: constant[p]["device_busy_ms"] for p in constant},
             device_activities_per_step={p: paths[p]["device_activities_per_step"]
                                         for p in paths},
             constant_lr_device_activities_per_step={
                 p: constant[p]["device_activities_per_step"] for p in constant},
             idle_share_unprofiled={p: paths[p]["idle_share_unprofiled"] for p in paths},
             graph_pool_gb=paths["graph"]["graph_pool_gb"],
             eager_peak_gb=paths["eager"]["peak_gb"], paths=paths)
    emit(event, **{k: v for k, v in r.items() if k != "paths"})
    per_step = {k: v * SCHED_STEPS for k, v in expected.items()}
    for path, got in launches.items():
        if {k: got.get(k, 0) for k in per_step} != per_step:
            raise SystemExit(f"{label}: launches on the {path} path {got}, expected {per_step}")
    if not all(np.isfinite(losses["graph"])):
        raise SystemExit(f"{label}: losses not finite: {losses['graph']}")
    for p, a in across.items():
        if not (a["lr_bit_equal"] and a["loss_bit_equal"] and a["state_differs"] == 0):
            raise SystemExit(f"{label}: the {p} path parts from the eager one: {a}")
    if counter0 is None:
        return r
    if any(c != want_counters for c in counters.values()) or \
            any(c != want_counters[-1] for c in final_counter.values()):
        raise SystemExit(f"{label}: counters {counters} / {final_counter}, expected "
                         f"{want_counters}")
    if not lr_rel <= SCHED_LR_REL:
        raise SystemExit(f"{label}: learning rates {lrs['graph']} part from the closed form "
                         f"{closed} by {lr_rel} relative (limit {SCHED_LR_REL})")
    return r


def _scheduled_step1_vs_cpu(torch, pt, prog, tot, params, init, feed, loss_rel, update_rel,
                            counter0):
    """Step 1 of a scheduled program at batch 2 on the card against the CPU
    port, from the same weights and counter."""
    init = dict(init, **{LR_COUNTER: torch.full((1,), counter0, dtype=torch.int64)})
    t0 = time.perf_counter()
    cpu = _step_once(torch, pt, prog, tot, params, {n: t.cpu() for n, t in init.items()},
                     feed, "cpu")
    cpu_s = time.perf_counter() - t0
    card = _step_once(torch, pt, prog, tot, params, init, feed, "cuda")
    gaps = dict(_gaps(card, cpu), loss_rel_limit=loss_rel, update_rel_l1_limit=update_rel,
                cpu_seconds=cpu_s)
    if not (gaps["loss_rel_gap"] <= loss_rel and gaps["update_rel_l1_gap"] <= update_rel):
        raise SystemExit(f"scheduled step 1: card vs CPU {gaps} exceeds the limits")
    return gaps


def _op_cases_on_card(torch):
    """Every case of ``tools/op_cases.py`` on the card against the CPU port,
    forward and (where the op is differentiable) the generic grad, with the
    case's tolerances (the 13 update ops' cases among them); each case whose
    gradient or update adds rows by index twice on the card, bit for bit;
    the random ops and ``dpsgd``'s noise by their statistics."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.tools import op_cases

    def compare(card, cpu, tol, what):
        worst = 0.0
        for slot, vals in cpu.items():
            for i, b in enumerate(vals):
                if b is None:
                    continue
                a = op_cases.numpy_outs({"x": [card[slot][i]]})["x"][0]
                b = op_cases.numpy_outs({"x": [b]})["x"][0]
                if a.shape != b.shape or a.dtype != b.dtype:
                    raise SystemExit(f"op case {what} {slot}: card {a.shape} {a.dtype}, "
                                     f"CPU {b.shape} {b.dtype}")
                a64, b64 = a.astype(np.float64), b.astype(np.float64)
                if not np.allclose(a64, b64, equal_nan=True, **tol):
                    raise SystemExit(f"op case {what} {slot}: the card parts from the CPU port "
                                     f"by {np.nanmax(np.abs(a64 - b64))} (tolerance {tol})")
                if a.size:
                    worst = max(worst, float(np.nanmax(np.abs(a64 - b64))))
        return worst

    def bit_equal(a, b):
        return all(x is None or torch.equal(x, y) for s in a for x, y in zip(a[s], b[s]))

    fwd_err, grad_err, repeats, n_grads = 0.0, 0.0, [], 0
    for name, c in sorted(op_cases.CASES.items()):
        cpu = op_cases.forward(name, "cpu")
        card = op_cases.forward(name, "cuda")
        fwd_err = max(fwd_err, compare(card, cpu, c.tol, name))
        if c.scatters and not bit_equal(card, op_cases.forward(name, "cuda")):
            raise SystemExit(f"op case {name}: two forwards on the card differ")
        if not c.grad:
            continue
        g_cpu = op_cases.grad(name, "cpu", cpu)
        g_card = op_cases.grad(name, "cuda", cpu)
        grad_err = max(grad_err, compare(g_card, g_cpu, c.grad_tol, name + " grad"))
        n_grads += 1
        if c.scatters:
            if not bit_equal(g_card, op_cases.grad(name, "cuda", cpu)):
                raise SystemExit(f"op case {name}: two gradients on the card differ")
            repeats.append(name)
    randoms = {}
    for op, (attrs, dtype) in sorted(op_cases.RANDOM_CASES.items()):
        out = registry.get(op).lower(registry.LowerCtx(dict(attrs), "cuda", seed=SEED,
                                                       counter=1), {})["Out"][0]
        why = op_cases.random_stats(op, out.cpu().numpy())
        if why is not None or str(out.dtype) != f"torch.{dtype}":
            raise SystemExit(f"{op} on the card: {why or out.dtype}")
        randoms[op] = dict(mean=float(out.double().mean()), std=float(out.double().std()))
    for op, (ins, attrs) in sorted(op_cases.NOISE_CASES.items()):    # dpsgd
        out = registry.get(op).lower(
            registry.LowerCtx(dict(attrs), "cuda", seed=SEED, counter=1),
            {k: [torch.from_numpy(a).cuda() for a in v] for k, v in ins.items()})["ParamOut"][0]
        why = op_cases.noise_stats(op, out.cpu().numpy())
        if why is not None:
            raise SystemExit(f"{op} on the card: {why}")
        randoms[op] = dict(noise_stats="held")
    ops = sorted({c.op for c in op_cases.CASES.values()} | set(op_cases.RANDOM_CASES)
                 | set(op_cases.NOISE_CASES))
    r = dict(cases=len(op_cases.CASES), op_types=len(ops), grads=n_grads,
             forward_max_abs_err=fwd_err, grad_max_abs_err=grad_err,
             repeated_bit_for_bit=repeats, random=randoms)
    emit("op_cases_on_card", **r)
    return r


def _constant_paths(torch, pt, build):
    """The graph and eager step of the constant-LR program ``build()``
    returns (main, startup, loss, feed), timed and profiled as
    ``_timed_path`` times them."""
    main, startup, loss, feed = build()
    init = _startup_state(pt, main, startup)
    paths = {("graph" if g else "eager"): _timed_path(torch, pt, main, feed, loss, init, g, True)
             for g in (True, False)}
    del main, startup, init
    torch.cuda.empty_cache()
    return paths


def phase_scheduled_training(torch, constant_bert=None, constant_nmt=None):
    """Phase 17: BERT-base pretraining under BERT's schedule and
    transformer-base under ``noam_decay(512, 4000)``, each beside its
    constant-LR step of this call (``constant_*``: the timed paths of phases
    11 and 13; timed here when not given, for a run of this phase alone);
    then every dense op case on the card."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.tools.train_profile import (
        BATCH, LR, MASKS_PER_SEQ, NMT_BATCH, NMT_LR, NMT_SEQ, SEQ, bert_schedule,
        bert_schedule_lr, build_pretrain, build_transformer, nmt_feed, noam_schedule,
        noam_schedule_lr, pretrain_feed, transformer_config)
    # (a) BERT-base, bench.py's configuration, BERT's warmup and linear decay
    cfg = bert.BertConfig(dtype="bfloat16", dropout=ATTN_DROPOUT)
    main, startup, total, pg = build_pretrain(cfg, BATCH, SEQ, MASKS_PER_SEQ, LR, SEED,
                                              schedule=bert_schedule)
    feed = pretrain_feed(np.random.RandomState(SEED), cfg, BATCH, SEQ, MASKS_PER_SEQ)
    feed = {k: torch.from_numpy(v).cuda() for k, v in feed.items()}
    if constant_bert is None:
        constant_bert = _constant_paths(torch, pt, lambda: build_pretrain(
            cfg, BATCH, SEQ, MASKS_PER_SEQ, LR, SEED)[:3] + (feed,))
    drops = sum(op.type == "dropout" and not op.attr("is_test", False)
                for op in main.global_block().ops)
    expected = {"flash_attn_fwd": cfg.n_layers, "flash_attn_bwd": cfg.n_layers,
                "multi_tensor_update": 1, "dropout_fwd": drops}
    bert_r = _scheduled_model(
        torch, pt, f"bert-base pretrain bf16 B{BATCH} S{SEQ} dropout {cfg.dropout} Adam under "
        f"linear_lr_warmup(polynomial_decay(1e-4, 1e6, 0), 10000, 0, 1e-4)",
        main, startup, feed, total, expected, BERT_COUNTER0, 2, bert_schedule_lr,
        constant_bert)
    init = _startup_state(pt, main, startup)
    del main, startup, feed
    torch.cuda.empty_cache()
    prog, _, tot, pg2 = build_pretrain(cfg, 2, SEQ, MASKS_PER_SEQ, LR, SEED,
                                       schedule=bert_schedule)
    _hidden_dropout_off(prog)
    feed2 = pretrain_feed(np.random.RandomState(SEED + 1), cfg, 2, SEQ, MASKS_PER_SEQ)
    bert_r["step1_card_vs_cpu_batch2"] = _scheduled_step1_vs_cpu(
        torch, pt, prog, tot, [p.name for p, _ in pg2], init, feed2, TRAIN_LOSS_REL,
        TRAIN_UPDATE_REL, BERT_COUNTER0)
    emit("scheduled_step1", model="bert-base", **bert_r["step1_card_vs_cpu_batch2"])
    del prog, init
    torch.cuda.empty_cache()

    # (b) transformer-base, bench_workloads.py's configuration, noam(512, 4000)
    ncfg = transformer_config()
    main, startup, loss, _ = build_transformer(ncfg, NMT_BATCH, NMT_SEQ, NMT_LR, SEED,
                                               schedule=noam_schedule)
    raw = nmt_feed(np.random.RandomState(SEED), ncfg, NMT_BATCH, NMT_SEQ)
    feed = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    if constant_nmt is None:
        constant_nmt = _constant_paths(torch, pt, lambda: build_transformer(
            ncfg, NMT_BATCH, NMT_SEQ, NMT_LR, SEED)[:3] + (feed,))
    drops = sum(op.type == "dropout" and not op.attr("is_test", False)
                for op in main.global_block().ops)
    nmt_r = _scheduled_model(
        torch, pt, f"transformer-base f32 B{NMT_BATCH} S{NMT_SEQ}+{NMT_SEQ} dropout "
        f"{ncfg.dropout} Adam under noam_decay(512, 4000)", main, startup, feed, loss,
        {"dropout_fwd": drops, "multi_tensor_update": 1}, NOAM_COUNTER0, 1, noam_schedule_lr,
        constant_nmt)
    init = _startup_state(pt, main, startup)
    del main, startup, feed
    torch.cuda.empty_cache()
    prog, _, tot, pg0 = build_transformer(transformer_config(dropout=0.0), NMT_CPU_BATCH,
                                          NMT_SEQ, NMT_LR, SEED, schedule=noam_schedule)
    feed2 = {k: v[:NMT_CPU_BATCH] for k, v in raw.items()}
    nmt_r["step1_card_vs_cpu_batch2_dropout0"] = _scheduled_step1_vs_cpu(
        torch, pt, prog, tot, [p.name for p, _ in pg0], init, feed2, NMT_LOSS_REL,
        NMT_UPDATE_REL, NOAM_COUNTER0)
    emit("scheduled_step1", model="transformer-base",
         **nmt_r["step1_card_vs_cpu_batch2_dropout0"])
    del prog, init
    torch.cuda.empty_cache()

    # (c) the dense op families, case by case
    cases = _op_cases_on_card(torch)
    return bert_r, nmt_r, cases


# Phase 18: the optimizer surface. A: BERT-base pretraining under LAMB and BERT's
# schedule; B: A under RecomputeOptimizer (a checkpoint at each encoder layer's
# output); C: ResNet-50 under LarsMomentum; D: the MNIST MLP under each update
# class and each averaging wrapper.
# B against A, eager path against eager path after SCHED_STEPS steps from one
# state: the same ops, except that B's backward takes autograd over a whole
# segment, which adds a residual's gradients in another order than the per-op
# graphs' ``sum`` ops; in bf16 that moves a gradient by an ulp, and LAMB's early
# update m / sqrt(v) turns such a gradient's sign, so phase 5's limits of two
# bf16 paths hold it (loss 1e-2 relative, update 0.1 of sum |update|).
RECOMPUTE_LOSS_REL, RECOMPUTE_UPDATE_REL = TRAIN_LOSS_REL, TRAIN_UPDATE_REL
#: path D: steps on each executor, and each class (learning rates at which the
#: MLP's loss falls over the steps on its repeated batch; Adadelta takes none).
#: Ftrl has l2 > 0: with l2 0 the reference's arithmetic divides 0 by 0 where a
#: gradient element and its squared accumulator are both 0 (a dead ReLU unit's
#: weights; ROADMAP fault 3.9), and the port keeps the reference's arithmetic
MNIST_OPT_STEPS = 6
MNIST_OPTIMIZERS = (
    ("AdamW", lambda pt: pt.optimizer.AdamW(1e-3)),
    ("Adagrad", lambda pt: pt.optimizer.Adagrad(1e-3)),
    ("Adamax", lambda pt: pt.optimizer.Adamax(1e-3)),
    ("Adadelta", lambda pt: pt.optimizer.Adadelta(1.0)),
    ("RMSProp centered", lambda pt: pt.optimizer.RMSProp(1e-4, centered=True)),
    ("Ftrl", lambda pt: pt.optimizer.Ftrl(1e-3, l2=1e-4)),
    ("DecayedAdagrad", lambda pt: pt.optimizer.DecayedAdagrad(1e-3)),
    ("Lamb", lambda pt: pt.optimizer.Lamb(1e-2)),
    ("LarsMomentum", lambda pt: pt.optimizer.LarsMomentum(0.1, 0.9)),
)
MNIST_WRAPPERS = ("ExponentialMovingAverage", "ModelAverage", "LookaheadOptimizer")


def _segment_dropouts(program):
    """(dropout ops in the global block, dropout ops in sub-blocks), training
    mode only."""
    count = lambda ops: sum(op.type == "dropout" and not op.attr("is_test", False) for op in ops)
    return (count(program.global_block().ops),
            sum(count(blk.ops) for blk in program.blocks[1:]))


def _lamb_bert(torch, pt, cfg, feed, constant, recompute, init):
    """Path A (``recompute`` False) or B: BERT-base under LAMB and BERT's
    schedule through ``_scheduled_model``, then step 1 against the CPU port
    at batch 2. Returns (result, the eager path's final state)."""
    from paddle_tpu_torch.tools.train_profile import (BATCH, LR, MASKS_PER_SEQ, SEQ,
                                                      bert_schedule, bert_schedule_lr,
                                                      build_pretrain, lamb, pretrain_feed)
    main, startup, total, pg = build_pretrain(cfg, BATCH, SEQ, MASKS_PER_SEQ, LR, SEED,
                                              schedule=bert_schedule, optimizer=lamb,
                                              checkpoints=recompute)
    ops = [op.type for op in main.global_block().ops]
    segments = ops.count("remat_segment")
    if ops.count("lamb") != len(pg) or segments != (cfg.n_layers if recompute else 0):
        raise SystemExit(f"LAMB BERT program: {ops.count('lamb')} lamb ops for {len(pg)} "
                         f"parameters, {segments} remat segments")
    glob, sub = _segment_dropouts(main)
    per_layer = 2 if recompute else 1
    expected = {"flash_attn_fwd": cfg.n_layers * per_layer, "flash_attn_bwd": cfg.n_layers,
                "multi_tensor_update": 1, "dropout_fwd": glob + 2 * sub}
    if init is None:
        init = _startup_state(pt, main, startup)
    elif set(_startup_state(pt, main, startup)) != set(init):
        raise SystemExit("the recompute program names its state otherwise than path A's")
    final = {}
    label = (f"bert-base pretrain bf16 B{BATCH} S{SEQ} dropout {cfg.dropout} "
             f"{'RecomputeOptimizer(' if recompute else ''}Lamb at its defaults, LayerNorm "
             f"excluded from weight decay{')' if recompute else ''}, under BERT's schedule")
    r = _scheduled_model(torch, pt, label, main, startup, feed, total, expected, BERT_COUNTER0,
                         2, bert_schedule_lr, constant, init=init, final=final,
                         event="optimizer_training")
    wds = [op.attr("weight_decay") for op in main.global_block().ops if op.type == "lamb"]
    r.update(path="B" if recompute else "A", lamb_ops=len(wds),
             excluded_from_weight_decay=wds.count(0.0), remat_segments=segments)
    del main, startup
    torch.cuda.empty_cache()
    prog, _, tot, pg2 = build_pretrain(cfg, 2, SEQ, MASKS_PER_SEQ, LR, SEED,
                                       schedule=bert_schedule, optimizer=lamb,
                                       checkpoints=recompute)
    _hidden_dropout_off(prog)
    feed2 = pretrain_feed(np.random.RandomState(SEED + 1), cfg, 2, SEQ, MASKS_PER_SEQ)
    r["step1_card_vs_cpu_batch2"] = _scheduled_step1_vs_cpu(
        torch, pt, prog, tot, [p.name for p, _ in pg2], init, feed2, TRAIN_LOSS_REL,
        TRAIN_UPDATE_REL, BERT_COUNTER0)
    emit("optimizer_step1", path=r["path"], **r["step1_card_vs_cpu_batch2"])
    del prog
    torch.cuda.empty_cache()
    return r, final, init


def _lars_resnet(torch, pt, constant):
    """Path C: ResNet-50 under LarsMomentum through ``_scheduled_model`` (a
    constant learning rate), then step 1 against the CPU port at batch 2:
    the bf16 program's loss, and the f32 build's loss and first velocity
    (phase 8's f32-update rule, ROADMAP fault 3.6)."""
    from paddle_tpu_torch.tools.train_profile import build_resnet50, lars
    main, startup, loss, pg, fused = build_resnet50(optimizer=lars)
    if [op.type for op in main.global_block().ops].count("lars_momentum") != len(pg):
        raise SystemExit("LARS ResNet-50 program: one lars_momentum op per parameter expected")
    feed = _resnet_feed(torch, np.random.RandomState(SEED), RESNET_BATCH, "cuda")
    init = _startup_state(pt, main, startup)
    r = _scheduled_model(
        torch, pt, f"resnet50 NHWC s2d bf16 B{RESNET_BATCH} 224x224 LarsMomentum(0.1, 0.9) "
        f"at its defaults, {fused} conv+bn chains fused", main, startup, feed, loss,
        {"fused_conv1x1_bn_fwd": fused, "multi_tensor_update": 1}, None, None, None, constant,
        init=init, event="optimizer_training")
    r.update(path="C", lars_ops=len(pg))
    if not all(np.isfinite(r["losses"]["eager"])) or \
            not r["losses"]["eager"][-1] < r["losses"]["eager"][0]:
        raise SystemExit(f"LARS ResNet-50: losses {r['losses']['eager']} not finite and falling")
    del main, startup, feed
    torch.cuda.empty_cache()
    feed2 = _resnet_feed(torch, np.random.RandomState(SEED + 1), 2, "cpu")
    gaps = {}
    for dt in ("bfloat16", "float32"):
        if dt == "bfloat16":
            prog, _, prog_loss, _, _ = build_resnet50(optimizer=lars)
            ini = init
        else:
            prog, _, prog_loss, _, _ = build_resnet50(dtype=dt, optimizer=lars)
            ini = {n: t.float() if t.is_floating_point() else t for n, t in init.items()}
        fd2 = {"img": feed2["img"].to(getattr(torch, dt)), "label": feed2["label"]}
        t0 = time.perf_counter()
        cpu_run = _resnet_step1(torch, pt, prog, prog_loss, {n: t.cpu() for n, t in ini.items()},
                                fd2, "cpu")
        cpu_s = time.perf_counter() - t0
        card_run = _resnet_step1(torch, pt, prog, prog_loss, ini,
                                 {k: v.to("cuda") for k, v in fd2.items()}, "cuda")
        gaps[dt] = dict(_resnet_gaps(card_run, cpu_run), cpu_seconds=cpu_s)
        del prog, card_run, cpu_run
        torch.cuda.empty_cache()
    r["step1_card_vs_cpu_batch2"] = gaps
    emit("optimizer_step1", path="C", **gaps, loss_rel_limit=RESNET_LOSS_REL,
         update_rel_l1_limit_f32=RESNET_UPDATE_REL)
    for dt, g in gaps.items():
        held = g["loss_rel_gap"] <= RESNET_LOSS_REL
        if dt == "float32":
            held = held and g["update_rel_l1_gap"] <= RESNET_UPDATE_REL
        if not held:
            raise SystemExit(f"LARS ResNet-50 step 1 ({dt}) card vs CPU: {g} exceeds the limits")
    return r


class _ThenUpdate:
    """Adam's ``minimize``, then an averaging wrapper's ``update()`` (its
    in-graph ops after the update's)."""

    def __init__(self, pt, wrapper):
        self.pt, self.wrapper = pt, wrapper

    def minimize(self, loss):
        out = self.pt.optimizer.Adam(1e-3).minimize(loss)
        self.wrapper.update()
        return out


def _apply_vs_numpy(torch, pt, scope, wrapper):
    """``apply()`` against numpy's arithmetic over the scope's values (bit
    for bit: one f32 division each), then ``restore()`` back to the trained
    values (bit for bit); the parameters' tensors stay the ones the scope
    held (written in place)."""
    params = wrapper._shadow if hasattr(wrapper, "_shadow") else wrapper._sums
    held = {p: scope.find_var(p) for p in params}
    trained = {p: t.clone() for p, t in held.items()}
    if hasattr(wrapper, "_shadow"):
        pw = np.float32(scope.find_var(wrapper._decay_pow_name).cpu().numpy()[0])
        den = np.float32(1.0) - pw if pw < 1 else np.float32(1.0)
        want = {p: scope.find_var(s).cpu().numpy() / den for p, s in params.items()}
    else:
        cnt = np.float32(scope.find_var(wrapper._count).cpu().numpy()[0])
        want = {p: scope.find_var(s).cpu().numpy() / cnt for p, s in params.items()}
    with pt.scope_guard(scope):
        with wrapper.apply():
            applied = all(np.array_equal(scope.find_var(p).cpu().numpy(), w)
                          for p, w in want.items())
            in_place = all(scope.find_var(p) is t for p, t in held.items())
    restored = all(torch.equal(scope.find_var(p), t) for p, t in trained.items())
    return dict(apply_equals_numpy=applied, written_in_place=in_place,
                restore_bit_equal=restored)


def _mnist_optimizers(torch, pt):
    """Path D: the MNIST MLP (``build_mnist``, B 256) under each class of
    ``MNIST_OPTIMIZERS`` and, over ``Adam(1e-3)``, each wrapper: graph
    against eager over MNIST_OPT_STEPS steps from one state (losses and
    every state tensor bit for bit), the loss finite and falling,
    ``multi_tensor_update`` once a step where the class has a kind; the
    wrappers' ``apply()`` / ``restore()`` against numpy over the scope on
    both paths, then one more step on each, still bit for bit."""
    from paddle_tpu_torch.core import cuda_build
    from paddle_tpu_torch.ops import multi_tensor
    from paddle_tpu_torch.tools.train_profile import build_mnist, mnist_feed
    feed = {k: torch.from_numpy(v).cuda() for k, v in mnist_feed(np.random.RandomState(SEED)).items()}
    results = []
    cases = [(n, make, None) for n, make in MNIST_OPTIMIZERS] + [(w, None, w) for w in MNIST_WRAPPERS]
    for name, make, wrap in cases:
        holder = {}

        def optimizer(pt_, make=make, wrap=wrap):
            if make is not None:
                return make(pt_)
            if wrap == "LookaheadOptimizer":
                return pt_.optimizer.LookaheadOptimizer(pt_.optimizer.Adam(1e-3), alpha=0.5, k=3)
            holder["w"] = (pt_.optimizer.ExponentialMovingAverage(0.9) if wrap.startswith("Exp")
                           else pt_.optimizer.ModelAverage())
            return _ThenUpdate(pt_, holder["w"])

        main, startup, loss, _, _ = build_mnist(optimizer=optimizer)
        kind = next((op.type for op in main.global_block().ops
                     if op.type in multi_tensor.GROUPED), None)
        init = _startup_state(pt, main, startup)
        runs, launches = {}, {}
        for path in ("eager", "graph"):
            exe = pt.Executor()
            exe._use_graphs = path == "graph"
            for fn in cuda_build.COUNTED:
                fn.launches = 0
            outs, state, scope = _steps(pt, exe, main, feed, [loss], init, MNIST_OPT_STEPS)
            torch.cuda.synchronize()
            launches[path] = multi_tensor.multi_tensor_update.launches
            extra = {}
            if "w" in holder:
                extra = _apply_vs_numpy(torch, pt, scope, holder["w"])
                with pt.scope_guard(scope):
                    outs.append(exe.run(main, feed=feed, fetch_list=[loss], return_numpy=False))
            runs[path] = ([o[0].clone() for o in outs],
                          {n: scope.find_var(n).clone() for n in init}, extra)
            exe.close()
            del exe, scope
        (e_l, e_s, e_x), (g_l, g_s, g_x) = runs["eager"], runs["graph"]
        losses = [float(x.reshape(-1)[0]) for x in g_l]
        want = MNIST_OPT_STEPS if kind is not None else 0
        r = dict(optimizer=name, kind=kind, losses=losses,
                 loss_bit_equal=all(torch.equal(a, b) for a, b in zip(g_l, e_l)),
                 state_differs=len(_state_equal(torch, g_s, e_s)),
                 multi_tensor_update_launches=launches, expected_launches=want,
                 apply_restore={"eager": e_x, "graph": g_x} if e_x else None)
        emit("optimizer_mnist", **r)
        if not (r["loss_bit_equal"] and r["state_differs"] == 0):
            raise SystemExit(f"MNIST MLP under {name}: graph parts from eager: {r}")
        if not (np.isfinite(losses).all() and losses[MNIST_OPT_STEPS - 1] < losses[0]):
            raise SystemExit(f"MNIST MLP under {name}: losses {losses} not finite and falling")
        if any(v != want for v in launches.values()):
            raise SystemExit(f"MNIST MLP under {name}: multi_tensor_update {launches}, "
                             f"expected {want}")
        if e_x and not all(all(x.values()) for x in (e_x, g_x)):
            raise SystemExit(f"MNIST MLP under {name}: apply()/restore() {e_x} / {g_x}")
        results.append(r)
        del main, startup, init, runs
    return results


def phase_optimizers(torch, constant_bert=None, constant_resnet=None):
    """Phase 18: paths A, B, C and D, each full-width path beside its
    constant-LR Adam / Momentum step of this call (``constant_*``: the timed
    paths of phase 11; timed here when not given, for a run of this phase
    alone)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.tools.train_profile import (BATCH, LR, MASKS_PER_SEQ, SEQ,
                                                      build_pretrain, build_resnet50,
                                                      pretrain_feed)
    cfg = bert.BertConfig(dtype="bfloat16", dropout=ATTN_DROPOUT)
    feed = pretrain_feed(np.random.RandomState(SEED), cfg, BATCH, SEQ, MASKS_PER_SEQ)
    feed = {k: torch.from_numpy(v).cuda() for k, v in feed.items()}
    if constant_bert is None:
        constant_bert = _constant_paths(torch, pt, lambda: build_pretrain(
            cfg, BATCH, SEQ, MASKS_PER_SEQ, LR, SEED)[:3] + (feed,))
    a, a_final, init = _lamb_bert(torch, pt, cfg, feed, constant_bert, False, None)
    b, b_final, _ = _lamb_bert(torch, pt, cfg, feed, constant_bert, True, init)
    bit_equal = all(torch.equal(a_final[n], b_final[n]) for n in a_final)
    la, lb = a["losses"]["eager"], b["losses"]["eager"]
    pool_a, pool_b = max(a["graph_pool_gb"]), max(b["graph_pool_gb"])
    vs = dict(losses_a=la, losses_b=lb, state_bit_equal=bit_equal,
              loss_rel_gap=max(abs(x - y) / abs(y) for x, y in zip(lb, la)),
              update_rel_l1_gap=_update_gap(init, b_final, a_final),
              loss_rel_limit=RECOMPUTE_LOSS_REL, update_rel_l1_limit=RECOMPUTE_UPDATE_REL,
              graph_pool_gb={"A": pool_a, "B": pool_b},
              eager_peak_gb={"A": a["eager_peak_gb"], "B": b["eager_peak_gb"]},
              step_ms={"A": a["step_ms"], "B": b["step_ms"]})
    emit("recompute_vs_plain", **vs)
    del a_final, b_final, init, feed
    torch.cuda.empty_cache()
    if not (vs["loss_rel_gap"] <= RECOMPUTE_LOSS_REL
            and vs["update_rel_l1_gap"] <= RECOMPUTE_UPDATE_REL):
        raise SystemExit(f"recompute (B) parts from LAMB (A) beyond the limits: {vs}")
    if not pool_b < pool_a:
        raise SystemExit(f"recompute did not cut the graph pool: B {pool_b} GB, A {pool_a} GB")
    if constant_resnet is None:
        def build():
            main, startup, loss, _, _ = build_resnet50()
            return main, startup, loss, _resnet_feed(torch, np.random.RandomState(SEED),
                                                     RESNET_BATCH, "cuda")
        constant_resnet = _constant_paths(torch, pt, build)
    c = _lars_resnet(torch, pt, constant_resnet)
    d = _mnist_optimizers(torch, pt)
    return a, b, vs, c, d


# -- phase 19: the rest of the training surface -----------------------------------------

#: A: bench.py's BERT-base batch, accumulated over 4 equal microbatches
PIPE_BATCH, PIPE_MICROBATCHES = 128, 4
#: A0: steps from one state, pipeline (dropout 0) against the plain B128 step
#: (dropout 0), held to phase 5's limits for two bf16 paths (TRAIN_LOSS_REL,
#: TRAIN_UPDATE_REL): the mean of 4 equal-count microbatch means is the batch
#: mean, so the two differ by the order of their sums and the bf16 roundings
#: of the gradients (each microbatch's gradient is rounded to the parameter's
#: dtype before it is summed)
#: (SCHED_STEPS, 4, until phase 30 was added; cut for the script's time)
PIPE_STEPS = 3
#: A0: step 1's accumulated gradients (the ``@mb_mean`` variables Adam reads)
#: against the plain step's, relative L1 over every parameter. Adam's update
#: hides a gradient's scale, so this is the card's check of the accumulation:
#: a lost or doubled 1/M parts the two by 3 or 1, a microbatch left out of the
#: sum by 0.25 or more; the two bf16 paths' roundings by far less (1.8e-3 on
#: the CPU port at H128 L2 B16 S32, M 4); 0.05 keeps room for both sides.
PIPE_GRAD_REL = 0.05
# B: transformer-base's step-1 loss under decorate(Adam) (bf16 products) against
# the f32 program's from the same weights and dropout masks. Each product's
# inputs are rounded to bf16 (2^-9 relative each) and its sum kept in f32: about
# one bf16 ulp of noise per element of each layer's output, with random signs,
# which moves each token's cross-entropy (about 10.4 at initialisation) by a few
# 1e-3 and their mean over 4096 tokens far less; 1e-2 bounds it with room.
AMP_LOSS_REL = 1e-2
# B: the parameter update after SCHED_STEPS steps of decorate(Adam) against the
# f32 program's from the same weights and masks: the check of AMP's backward
# (the casts' gradients, the bf16 products' gradients) and its update. Two
# paths that part by bf16 roundings, held to phase 5's limit for two bf16 paths
# (TRAIN_UPDATE_REL); the CPU port reads 0.0076 at H128 L2 B8 S32.
AMP_UPDATE_REL = TRAIN_UPDATE_REL
# B2: the MNIST MLP under fp16 dynamic loss scaling: SGD(0.01), init scale 1024,
# grow by 2 after 2 finite steps, halve on an overflow; step 3's batch holds an
# inf. The scale after each step, in closed form: 1024 (1 good step), 2048 (2:
# grow), 1024 (overflow: halve), 1024, 2048, 2048.
AMP_INIT_SCALE, AMP_INCR_EVERY, AMP_STEPS, AMP_OVERFLOW_STEP = 1024.0, 2, 6, 3
AMP_SCALES = [1024.0, 2048.0, 1024.0, 1024.0, 2048.0, 2048.0]
#: C: the image chapter under the input-gradient penalty, random CIFAR-shaped images
PENALTY_BATCH = 128
#: D: the WGAN-GP objective at tests/test_double_grad.py's size: 200 Adam steps
#: (its bar: the penalty below half its first value), the first 5 against the
#: CPU port from the same weights. f32 on both, the card's sums in other orders
#: through two backward passes of a 2-layer MLP: 1e-4 relative.
WGAN_STEPS, WGAN_CPU_STEPS, WGAN_REL = 200, 5, 1e-4
#: D: the second order through dropout against its closed form over the
#: forward's Mask (2 y Mask / (1 - p), 2 Mask^2 / (1 - p)^2 v): f32, one
#: product and a division by 0.5 on each side: 1e-6 relative
DROPOUT_2ND_REL = 1e-6


def _pipeline_bert(torch, pt, constant):
    """Path A: BERT-base pretraining under ``PipelineOptimizer(Adam,
    num_microbatches=4, schedule="scan")`` at phase 11's configuration,
    through ``_scheduled_model`` (constant LR) beside phase 11's plain B128
    step; then A0: at dropout 0 against the plain B128 step at dropout 0,
    PIPE_STEPS steps from one state on the graph executor."""
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.tools.train_profile import (BATCH, LR, MASKS_PER_SEQ, SEQ,
                                                      build_pretrain, global_mask_pos,
                                                      pipeline, pretrain_feed)
    assert BATCH == PIPE_BATCH
    M = PIPE_MICROBATCHES
    cfg = bert.BertConfig(dtype="bfloat16", dropout=ATTN_DROPOUT)
    raw = pretrain_feed(np.random.RandomState(SEED), cfg, BATCH, SEQ, MASKS_PER_SEQ, M)
    feed = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    main, startup, total, pg = build_pretrain(cfg, BATCH, SEQ, MASKS_PER_SEQ, LR, SEED,
                                              optimizer=pipeline(M))
    ops = [op.type for op in main.global_block().ops]
    glob, body = _segment_dropouts(main)
    body_attn = sum(op.type == "fused_attention" for op in main.blocks[1].ops)
    if ops.count("scan") != 1 or ops.count("adam") != len(pg) or body_attn != cfg.n_layers \
            or glob != 0:
        raise SystemExit(f"pipeline BERT program: {ops.count('scan')} scans, "
                         f"{ops.count('adam')} adam ops for {len(pg)} parameters, "
                         f"{body_attn} attentions and {body} dropouts in the body, {glob} out")
    expected = {"flash_attn_fwd": cfg.n_layers * M, "flash_attn_bwd": cfg.n_layers * M,
                "dropout_fwd": body * M, "multi_tensor_update": 1}
    label = (f"bert-base pretrain bf16 B{BATCH} as {M} x {BATCH // M} S{SEQ} dropout "
             f"{cfg.dropout} PipelineOptimizer(Adam({LR}), num_microbatches={M}, "
             f"schedule='scan')")
    r = _scheduled_model(torch, pt, label, main, startup, feed, total, expected, None, None,
                         None, constant, event="pipeline_training", fused=False)
    # the attention kernels' device time a launch inside the scan's body, from
    # the trace of the graph path's PROFILED_STEPS captured steps
    graph = r["paths"]["graph"]
    recs, rec_ms = graph.pop("device_records"), graph.pop("device_ms_by_record")
    in_scan = {}
    for kernel, pats in (("flash_attn_fwd", ("flash_fwd",)),
                         ("flash_attn_bwd", ("bwd_dkdv", "bwd_dq", "flash_bwd"))):
        names = [k for k in recs if any(p_ in k for p_ in pats)]
        n = sum(recs[k] for k in names) / PROFILED_STEPS
        in_scan[kernel] = dict(records=names, launches_per_step=n,
                               ms_per_launch=(sum(rec_ms[k] for k in names) / n) if n else None)
    emit("pipeline_kernels_in_scan", **in_scan)
    r.update(path="A", microbatches=M, microbatch_batch=BATCH // M, body_dropouts=body,
             kernel_in_scan=in_scan)
    del main, startup, feed
    torch.cuda.empty_cache()

    # A0: dropout 0, the pipeline against the plain step on the same tokens
    cfg0 = bert.BertConfig(dtype="bfloat16", dropout=0.0)
    pipe, pstart, ptotal, pipe_pg = build_pretrain(cfg0, BATCH, SEQ, MASKS_PER_SEQ, LR, SEED,
                                                   optimizer=pipeline(M))
    plain, _, ltotal, plain_pg = build_pretrain(cfg0, BATCH, SEQ, MASKS_PER_SEQ, LR, SEED)
    init = _startup_state(pt, pipe, pstart)
    if set(_startup_state(pt, plain, pstart)) != set(init):
        raise SystemExit("the pipeline program names its state otherwise than the plain one")
    feed_host = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    plain_feed = dict(feed_host, mask_pos=torch.from_numpy(
        global_mask_pos(raw["mask_pos"], M, BATCH, SEQ)).cuda())
    # each parameter's gradient as Adam reads it: the pipeline's accumulated
    # mean, the plain step's own
    grads = {"pipeline": [g.name + "@mb_mean" for _, g in pipe_pg if g is not None],
             "plain": [g.name for _, g in plain_pg if g is not None]}
    runs = {}
    for name, prog, loss, fd in (("pipeline", pipe, ptotal, feed_host),
                                 ("plain", plain, ltotal, plain_feed)):
        exe = pt.Executor()
        outs, state, _ = _steps(pt, exe, prog, fd, [loss] + grads[name], init, PIPE_STEPS)
        runs[name] = ([float(o[0].float().reshape(-1)[0]) for o in outs],
                      {n: t.clone() for n, t in state.items()}, outs[0][1:])
        exe.close()
        del exe, outs, state
    (lp, sp, gp), (ll, sl, gl) = runs["pipeline"], runs["plain"]
    grad_gap = (sum(float((a.float() - b.float()).abs().sum()) for a, b in zip(gp, gl))
                / sum(float(b.float().abs().sum()) for b in gl))
    a0 = dict(losses_pipeline=lp, losses_plain=ll,
              loss_rel_gap=max(abs(a - b) / abs(b) for a, b in zip(lp, ll)),
              update_rel_l1_gap=_update_gap(init, sp, sl), steps=PIPE_STEPS,
              step1_grad_rel_l1_gap=grad_gap, grads=len(gl),
              loss_rel_limit=TRAIN_LOSS_REL, update_rel_l1_limit=TRAIN_UPDATE_REL,
              grad_rel_l1_limit=PIPE_GRAD_REL)
    emit("pipeline_vs_plain", **a0)
    r["A0"] = a0
    del runs, sp, sl, gp, gl, init, pipe, plain, feed_host, plain_feed
    torch.cuda.empty_cache()
    if not (a0["loss_rel_gap"] <= TRAIN_LOSS_REL and a0["update_rel_l1_gap"] <= TRAIN_UPDATE_REL
            and grad_gap <= PIPE_GRAD_REL):
        raise SystemExit(f"A0: the pipeline parts from the plain step beyond the limits: {a0}")
    return r


def _product_dtypes(program):
    """The white-list products (``mul``, ``matmul``, ...) of ``program`` by
    the dtype of their first input."""
    from paddle_tpu_torch.contrib.mixed_precision import AutoMixedPrecisionLists
    white = AutoMixedPrecisionLists().white_list
    out = {}
    for op in program.global_block().ops:
        if op.type in white:
            dt = program.global_block().var(op.input(next(iter(op.inputs)))[0]).dtype
            out[dt] = out.get(dt, 0) + 1
    return out


def _amp_transformer(torch, pt, constant):
    """Path B: transformer-base under ``mixed_precision.decorate(Adam)`` at
    its defaults (bf16, no scaling) through ``_scheduled_model`` beside phase
    13's f32 step; step 1's loss, and the update after SCHED_STEPS steps,
    against the f32 program's from the same weights."""
    from paddle_tpu_torch.tools.train_profile import (NMT_LR, amp_adam, build_transformer,
                                                      nmt_feed, transformer_config)
    cfg = transformer_config()
    main, startup, loss, pg = build_transformer(cfg, optimizer=amp_adam)
    f32, _, f32_loss, _ = build_transformer(cfg)
    casts = (sum(op.type == "cast" for op in main.global_block().ops)
             - sum(op.type == "cast" for op in f32.global_block().ops))
    products = {"amp": _product_dtypes(main), "f32": _product_dtypes(f32)}
    feed = {k: torch.from_numpy(v).cuda()
            for k, v in nmt_feed(np.random.RandomState(SEED), cfg).items()}
    init = _startup_state(pt, main, startup)
    step1, final = {}, {}
    for name, prog, l in (("amp", main, loss), ("f32", f32, f32_loss)):
        exe = pt.Executor()
        outs, state, _ = _steps(pt, exe, prog, feed, [l], init, SCHED_STEPS)
        step1[name] = float(outs[0][0].reshape(-1)[0])
        final[name] = {n: t.clone() for n, t in state.items()}
        exe.close()
        del exe, outs, state
    step1_rel = abs(step1["amp"] - step1["f32"]) / abs(step1["f32"])
    update_rel = _update_gap(init, final["amp"], final["f32"])
    del final
    drops = sum(op.type == "dropout" and not op.attr("is_test", False)
                for op in main.global_block().ops)
    r = _scheduled_model(
        torch, pt, f"transformer-base f32 program under mixed_precision.decorate(Adam({NMT_LR})) "
        f"(bf16 products, no loss scaling) B64 S64+64 dropout {cfg.dropout}", main, startup,
        feed, loss, {"dropout_fwd": drops, "multi_tensor_update": 1}, None, None, None,
        constant, init=init, event="amp_training", fused=False)
    r.update(path="B", casts_inserted=casts, products_by_dtype=products,
             step1_loss=step1, step1_loss_rel_gap=step1_rel, step1_loss_rel_limit=AMP_LOSS_REL,
             update_steps=SCHED_STEPS, update_rel_l1_gap=update_rel,
             update_rel_l1_limit=AMP_UPDATE_REL,
             product_device_ms={
                 "amp (bf16 products)": r["paths"]["graph"]["by_kind"].get("matmul", {}).get("ms"),
                 "f32": constant["graph"]["by_kind"].get("matmul", {}).get("ms")})
    emit("amp_step1", **{k: r[k] for k in ("casts_inserted", "products_by_dtype", "step1_loss",
                                          "step1_loss_rel_gap", "update_rel_l1_gap",
                                          "product_device_ms")})
    del main, startup, f32, feed, init
    torch.cuda.empty_cache()
    if set(products["amp"]) != {"bfloat16"} or set(products["f32"]) != {"float32"}:
        raise SystemExit(f"AMP transformer: products by dtype {products}")
    if not step1_rel <= AMP_LOSS_REL:
        raise SystemExit(f"AMP transformer: step-1 loss {step1} parts by {step1_rel} relative "
                         f"(limit {AMP_LOSS_REL})")
    if not update_rel <= AMP_UPDATE_REL:
        raise SystemExit(f"AMP transformer: the update after {SCHED_STEPS} steps parts from the "
                         f"f32 program's by {update_rel} relative L1 (limit {AMP_UPDATE_REL})")
    return r


def _bits(torch, t):
    """A float tensor's bits, so that NaNs compare equal to themselves."""
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


def _amp_scaling_mnist(torch, pt):
    """Path B2: the MNIST MLP under fp16 dynamic loss scaling for AMP_STEPS
    steps, step AMP_OVERFLOW_STEP fed a batch holding an inf, on the eager
    executor, the graph executor and the CPU port from one state: the scale
    after each step equal to its closed form on all three, the parameters
    unchanged by the overflowed step, graph against eager bit for bit."""
    from paddle_tpu_torch.ops import multi_tensor
    from paddle_tpu_torch.tools.train_profile import build_mnist, mnist_feed
    holder = {}

    def optimizer(p):
        holder["o"] = p.contrib.mixed_precision.decorate(
            p.optimizer.SGD(0.01), dest_dtype="float16", use_dynamic_loss_scaling=True,
            init_loss_scaling=AMP_INIT_SCALE, incr_every_n_steps=AMP_INCR_EVERY)
        return holder["o"]

    main, startup, loss, _, pg = build_mnist(optimizer=optimizer)
    scale = holder["o"].get_loss_scaling()
    params = [p.name for p, _ in pg]
    feeds = [mnist_feed(np.random.RandomState(SEED + i)) for i in range(AMP_STEPS)]
    feeds[AMP_OVERFLOW_STEP - 1]["img"][0, 0] = np.inf
    init = _startup_state(pt, main, startup)
    runs = {}
    for path in ("eager", "graph", "cpu"):
        dev = "cpu" if path == "cpu" else "cuda"
        exe = pt.Executor(pt.CPUPlace() if path == "cpu" else None)
        exe._use_graphs = path == "graph"
        multi_tensor.multi_tensor_update.launches = 0
        scope = pt.Scope()
        for n, t in init.items():
            scope.set_var(n, t.to(dev, copy=True))
        main._rng_run_counter = 0
        outs, states = [], []
        with pt.scope_guard(scope):
            for f in feeds:
                o = exe.run(main, feed={k: torch.from_numpy(v).to(dev) for k, v in f.items()},
                            fetch_list=[loss, scale], return_numpy=False)
                outs.append([x.clone() for x in o])
                states.append({n: scope.find_var(n).clone() for n in params})
        runs[path] = (outs, states, multi_tensor.multi_tensor_update.launches)
        exe.close()
        del exe, scope
    scales = {p: [float(o[1].reshape(-1)[0]) for o in runs[p][0]] for p in runs}
    losses = {p: [float(o[0].float().reshape(-1)[0]) for o in runs[p][0]] for p in runs}
    (g_outs, g_states, g_launch), (e_outs, e_states, e_launch) = runs["graph"], runs["eager"]
    bit_equal = all(torch.equal(_bits(torch, a), _bits(torch, b))
                    for x, y in zip(g_outs, e_outs) for a, b in zip(x, y)) and \
        all(torch.equal(x[n], y[n]) for x, y in zip(g_states, e_states) for n in params)
    k = AMP_OVERFLOW_STEP - 1
    unchanged = {p: all(torch.equal(runs[p][1][k - 1][n], runs[p][1][k][n]) for n in params)
                 for p in runs}
    moved_after = all(not torch.equal(g_states[k][n], g_states[k + 1][n]) for n in params)
    r = dict(path="B2", model=f"mnist mlp B256 fp16 dynamic loss scaling (init {AMP_INIT_SCALE}, "
             f"incr every {AMP_INCR_EVERY}) SGD(0.01), step {AMP_OVERFLOW_STEP} fed an inf",
             scales=scales, closed_form=AMP_SCALES, losses=losses, graph_bit_equal=bit_equal,
             params_unchanged_on_overflow=unchanged, params_move_after=moved_after,
             multi_tensor_update_launches={"graph": g_launch, "eager": e_launch})
    emit("amp_loss_scaling", **r)
    if any(s != AMP_SCALES for s in scales.values()):
        raise SystemExit(f"AMP loss scaling: scales {scales}, closed form {AMP_SCALES}")
    if not (bit_equal and all(unchanged.values()) and moved_after):
        raise SystemExit(f"AMP loss scaling: graph/eager or the overflow step: {r}")
    if not (np.isnan(losses["graph"][k]) and np.isfinite(losses["graph"][k + 1:]).all()):
        raise SystemExit(f"AMP loss scaling: losses {losses['graph']}")
    return r


def _penalty_vgg(torch, pt):
    """Path C: the image chapter (VGG-16 with batch norm, B 128, 3 x 32 x 32,
    dropout 0.5, Adam 1e-3) under the input-gradient penalty
    (``book.build_image_penalty``) through ``_scheduled_model``, fetching
    the penalty, beside the plain chapter's step timed in this call."""
    from paddle_tpu_torch.models import vgg
    from paddle_tpu_torch.tools import book
    ch, penalty = book.build_image_penalty(pt, vgg)
    plain = book.build_image_classification(pt, vgg)
    rng = np.random.RandomState(SEED)
    feed = {"img": torch.from_numpy(rng.randn(PENALTY_BATCH, 3, 32, 32).astype("float32")).cuda(),
            "label": torch.from_numpy(rng.randint(0, 10, (PENALTY_BATCH, 1)).astype("int64")
                                      ).cuda()}
    ops = [op.type for op in ch.main.global_block().ops]
    # a dropout runs its kernel in the forward and again where its first-pass
    # grad op, differentiated again, recomputes it with the graph kept
    drops = ops.count("dropout") + ops.count("dropout_grad_grad")
    constant = _constant_paths(torch, pt, lambda: (plain.main, plain.startup, plain.loss, feed))
    r = _scheduled_model(
        torch, pt, f"image chapter VGG-16-BN B{PENALTY_BATCH} 3x32x32 dropout 0.5 Adam(1e-3) "
        f"+ {book.IMG_PENALTY} * mean(sum((d loss / d img)^2)) (fetched: the penalty)",
        ch.main, ch.startup, feed, penalty, {"dropout_fwd": drops, "multi_tensor_update": 1},
        None, None, None, constant, event="second_order_training", fused=False)
    r.update(path="C", grad_grad_ops=sum(t.endswith("_grad_grad") for t in ops),
             ops=len(ops))
    del ch, plain, feed, constant
    torch.cuda.empty_cache()
    pen = r["losses"]["eager"]
    if not pen[-1] < pen[0]:
        raise SystemExit(f"the input-gradient penalty did not fall: {pen}")
    return r


def _double_grad_on_card(torch, pt):
    """D: the 12 second-order op cases of ``tools/double_grad.py`` on the
    card against the CPU port; the second-order refusals of the kernels'
    Functions on the card; the WGAN-GP objective over WGAN_STEPS steps."""
    from paddle_tpu_torch.tools import double_grad as dg
    cases = []
    for name, c in dg.CASES.items():
        card, cpu = dg.run(name, "cuda"), dg.run(name, "cpu")
        err = max(float(np.abs(a - b).max()) for a, b in zip(card, cpu))
        ok = all(np.allclose(a, b, atol=c.tol, rtol=c.tol) for a, b in zip(card, cpu))
        cases.append(dict(case=name, max_abs_err=err, tol=c.tol, ok=ok))
    refusals = {}
    attn, conv = dg.attention_case("auto"), dg.conv_bn_case()
    # a second order through a kernel's Function raises a NotImplementedError
    # naming what is missing, on the card (``refused``: its message holds ``want``)
    for label, case, want in (("fused_attention", attn, "double-backward kernel"),
                              ("conv2d_bn_fused", conv, "conv2d_bn_fused")):
        main, feed, fetch = dg.build(pt, case)
        try:
            with pt.scope_guard(pt.Scope()):
                pt.Executor().run(main, feed=feed, fetch_list=fetch)
            refusals[label] = dict(refused=False, message=None)
        except NotImplementedError as e:
            refusals[label] = dict(refused=want in str(e), message=str(e))
    # the plain attention (impl "composed") is differentiable twice on the card
    main, feed, fetch = dg.build(pt, attn._replace(attrs=dict(attn.attrs, impl="composed")))
    with pt.scope_guard(pt.Scope()):
        composed = pt.Executor().run(main, feed=feed, fetch_list=fetch)
    with pt.scope_guard(pt.Scope()):
        composed_cpu = pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=fetch)
    composed_err = max(float(np.abs(a - b).max()) for a, b in zip(composed, composed_cpu))
    composed_ok = all(np.allclose(a, b, atol=dg.SUMS, rtol=dg.SUMS)
                      for a, b in zip(composed, composed_cpu))

    # second order through the dropout kernel's Function: its closed form over
    # the forward's own Mask (the grad op recomputed with the forward's salt)
    main, fetch = dg.build_dropout(pt)
    feed = dg.dropout_feed()
    with pt.scope_guard(pt.Scope()):
        y, g, h, mask = pt.Executor().run(main, feed=feed, fetch_list=fetch)
    dropout_gaps = dg.dropout_gaps(y, g, h, mask, feed["v"])

    main, startup, total, penalty = dg.build_penalty(pt)
    init = _startup_state(pt, main, startup)
    feed = {k: torch.from_numpy(v).cuda() for k, v in dg.penalty_feed().items()}
    exe = pt.Executor()
    outs, _, _ = _steps(pt, exe, main, feed, [penalty], init, WGAN_STEPS)
    card = [float(o[0].reshape(-1)[0]) for o in outs]
    exe.close()
    scope = pt.Scope()
    for n, t in init.items():
        scope.set_var(n, t.cpu().clone())
    main._rng_run_counter = 0
    with pt.scope_guard(scope):
        cexe = pt.Executor(pt.CPUPlace())
        cpu = [float(cexe.run(main, feed=dg.penalty_feed(), fetch_list=[penalty])[0][0])
               for _ in range(WGAN_CPU_STEPS)]
    wgan_rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    r = dict(cases=cases, refusals_on_card=refusals,
             dropout_second_order_rel_gaps=dict(first=dropout_gaps[0], second=dropout_gaps[1],
                                                limit=DROPOUT_2ND_REL),
             attention_composed_card_vs_cpu=dict(max_abs_err=composed_err, ok=composed_ok),
             wgan_gp=dict(steps=WGAN_STEPS, penalty_first=card[0], penalty_last=card[-1],
                          card_vs_cpu_rel_gap=wgan_rel, rel_limit=WGAN_REL,
                          cpu_steps=WGAN_CPU_STEPS))
    emit("double_grad_on_card", **r)
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise SystemExit(f"second-order op cases on the card part from the CPU port: {bad}")
    if not all(x["refused"] for x in refusals.values()):
        raise SystemExit(f"second order through a kernel's Function: {refusals}")
    if not composed_ok:
        raise SystemExit(f"composed attention's second order: card vs CPU {composed_err}")
    if max(dropout_gaps) > DROPOUT_2ND_REL:
        raise SystemExit(f"second order through dropout: gaps {dropout_gaps} from the "
                         f"closed form over the forward's mask")
    if not (wgan_rel <= WGAN_REL and card[-1] < 0.5 * card[0]):
        raise SystemExit(f"WGAN-GP on the card: {r['wgan_gp']}")
    return r


def phase_training_surface(torch, constant_bert=None, constant_nmt=None):
    """Phase 19: A (and A0), B, B2, C and D, each full-width path beside its
    yardstick of this call (``constant_*``: phase 11's plain BERT-base step
    and phase 13's f32 transformer-base step; timed here when not given,
    for a run of this phase alone)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.tools.train_profile import (BATCH, LR, MASKS_PER_SEQ, SEQ,
                                                      build_pretrain, build_transformer,
                                                      nmt_feed, pretrain_feed,
                                                      transformer_config)
    t0 = time.perf_counter()
    if constant_bert is None:
        cfg = bert.BertConfig(dtype="bfloat16", dropout=ATTN_DROPOUT)
        feed = {k: torch.from_numpy(v).cuda() for k, v in pretrain_feed(
            np.random.RandomState(SEED), cfg, BATCH, SEQ, MASKS_PER_SEQ).items()}
        constant_bert = _constant_paths(torch, pt, lambda: build_pretrain(
            cfg, BATCH, SEQ, MASKS_PER_SEQ, LR, SEED)[:3] + (feed,))
    if constant_nmt is None:
        cfg = transformer_config()
        feed = {k: torch.from_numpy(v).cuda()
                for k, v in nmt_feed(np.random.RandomState(SEED), cfg).items()}
        constant_nmt = _constant_paths(torch, pt, lambda: build_transformer(cfg)[:3] + (feed,))
    a = _pipeline_bert(torch, pt, constant_bert)
    b = _amp_transformer(torch, pt, constant_nmt)
    b2 = _amp_scaling_mnist(torch, pt)
    c = _penalty_vgg(torch, pt)
    d = _double_grad_on_card(torch, pt)
    emit("training_surface", seconds=time.perf_counter() - t0)
    return a, b, b2, c, d


# -- phase 20: streaming, checkpoints, the step guardian, host tables --------------------
# A: DeepFM (phase 14's configuration) from one FileTailSource per part file of
# phase 15 (200,000 rows in 8 parts), merged in a fixed rotation (``ordered``),
# under StepGuardian and an async Checkpointer every 8 steps, captured; faults:
# a transient exc at dispatch (retried) and a corrupt record at parse
# (quarantined), then a preempt at step 8; the resume runs to step 16 (24, 12
# and 8 until the C ABI's phase 28 was added; cut for the script's time).
STREAM_STEPS, STREAM_PREEMPT, STREAM_SAVE_EVERY = 16, 8, 4
STREAM_FAULTS = "exc@dispatch:step=5;corrupt@parse:step=1000"
# A's check of the default (arrival-order) merge: preempted, then resumed (12
# and 6 until phase 28)
ARRIVAL_STEPS, ARRIVAL_PREEMPT = 8, 4
# B: examples/ctr_deepfm.py's program (host_embedding + Adagrad, 256-128, Adam)
# at the example's constants (50 steps; 200 until phase 28, 100 until phase 30)
# and at A's scale (12 steps; 20 until phase 30)
CTR_EXAMPLE = dict(vocab=20_000, batch=512, steps=50)
CTR_AT_SCALE = dict(vocab=1_000_000, batch=4096, steps=12)
HOST_FIELDS, HOST_DIM, HOST_DENSE = 26, 16, 13
HOST_PROFILED_STEPS = 5
HOST_FETCH_FAULT = "exc@fetch:step=3"


def _hist_totals(name, key="mode", **match):
    """(count, sum) of a histogram in the metrics registry by its ``key``
    label, over the children whose labels include ``match``."""
    from paddle_tpu_torch.observability.metrics import REGISTRY
    fam = REGISTRY.get(name)
    out = {}
    for k, c in (fam.items() if fam else ()):
        labels = dict(k)
        if all(labels.get(a) == b for a, b in match.items()):
            out[labels.get(key, "")] = (c.count, c.sum)
    return out


def _hist_delta(before, after):
    out = {}
    for mode, (n, s) in after.items():
        n0, s0 = before.get(mode, (0, 0.0))
        if n > n0:
            out[mode] = dict(saves=n - n0, seconds_mean=(s - s0) / (n - n0))
    return out


def _zero_launches():
    from paddle_tpu_torch.core import cuda_build
    for f in cuda_build.COUNTED:
        f.launches = 0


def _arrival_resume(paths, use_vars, guarded, fresh, main, workdir):
    """Path A's check of the default merge (arrival order, the JAX
    package's): preempted at ``ARRIVAL_PREEMPT`` and resumed to
    ``ARRIVAL_STEPS`` under the guardian, the batches the two runs trained
    must hold each record of a prefix of each file exactly once. Its
    batches differ from run to run (ROADMAP fault 3.15), so no state is
    compared."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.data import FileTailSource, StreamingDataset
    from paddle_tpu_torch.ops import multi_tensor
    from paddle_tpu_torch.resilience import recovery
    from paddle_tpu_torch.tools.train_profile import CTR_BATCH
    from paddle_tpu_torch.utils.checkpointer import Checkpointer
    steps, preempt = ARRIVAL_STEPS, ARRIVAL_PREEMPT

    class Recorded(StreamingDataset):
        def _iter_batches(self):
            for feed in super()._iter_batches():
                self.yielded.append(np.array(feed["ids"]))
                yield feed

    def make_ds(bound):
        ds = Recorded()
        ds.yielded = []
        for p in paths:
            ds.add_source(FileTailSource(p, name=os.path.basename(p)))
        ds.set_use_var(use_vars)
        ds.set_batch_size(CTR_BATCH)
        ds.set_epoch_bound(steps=bound)
        return ds
    ck_dir = os.path.join(workdir, "ck_arrival")
    _zero_launches()
    scope_p, exe_p = fresh()
    _, pre, _, ds_p, _ = guarded(ck_dir, f"preempt:step={preempt}", steps, scope_p, exe_p,
                                 ds=make_ds(steps))
    launches_p = multi_tensor.multi_tensor_update.launches
    if pre is None:
        raise SystemExit("stream A, arrival merge: the preempt fault did not preempt the run")
    del scope_p, exe_p
    recovery.clear_preemption()
    scope_r, exe_r = fresh()
    ck_r = Checkpointer(exe_r, main, ck_dir, save_interval_steps=STREAM_SAVE_EVERY,
                        async_save=True)
    with pt.scope_guard(scope_r):
        restored = ck_r.restore()
    ds_r = make_ds(steps - restored - 1)
    ds_r.seek(ck_r.train_state["stream"])
    _zero_launches()
    _, pre_r, _, _, g_r = guarded(None, None, steps, scope_r, exe_r, ds=ds_r,
                                  start=restored + 1, ck=ck_r)
    ck_r.wait()
    launches_r = multi_tensor.multi_tensor_update.launches
    g_r.close()
    # where each record lies: (file, line), keyed by its ids
    where = {}
    for k, p in enumerate(paths):
        with open(p) as f:
            vals = np.fromstring(f.read().replace(";", " "), sep=" ")
        ids = vals.reshape(-1, 40)[:, :26].astype(np.int64)
        where.update((row.tobytes(), (k, i)) for i, row in enumerate(ids))
    trained = ds_p.yielded[:restored + 1] + ds_r.yielded
    rows = [where.get(r.tobytes()) for b in trained for r in b]
    per_file = [sorted(i for kk, i in rows if kk == k) for k in range(len(paths))]
    r = dict(steps=steps, preempt_at=preempt, restored_step=restored,
             records=len(rows), unknown=sum(x is None for x in rows),
             distinct=len(set(rows)), per_file=[len(x) for x in per_file],
             prefixes=all(x == list(range(len(x))) for x in per_file),
             multi_tensor_update_launches=launches_p + launches_r)
    r["exactly_once"] = (pre_r is None and r["unknown"] == 0 and r["prefixes"]
                         and r["records"] == r["distinct"] == steps * CTR_BATCH)
    if not r["exactly_once"]:
        raise SystemExit(f"stream A, arrival merge: the resume dropped or replayed records: {r}")
    if r["multi_tensor_update_launches"] != steps:
        raise SystemExit(f"stream A, arrival merge: multi_tensor_update launched "
                         f"{launches_p} + {launches_r} times, expected {steps}")
    return r


def _stream_resume(torch, pt, workdir, deepfm_step_ms=None):
    """Path A of phase 20."""
    from paddle_tpu_torch.data import FileTailSource, StreamingDataset
    from paddle_tpu_torch.ops import multi_tensor
    from paddle_tpu_torch.resilience import faults, recovery
    from paddle_tpu_torch.tools.train_profile import CTR_BATCH, CTR_FIELDS, CTR_VOCAB, \
        build_deepfm, traced
    from paddle_tpu_torch.utils.checkpointer import Checkpointer
    from torch.profiler import ProfilerActivity
    steps, preempt, save_every, spec = (STREAM_STEPS, STREAM_PREEMPT, STREAM_SAVE_EVERY,
                                        STREAM_FAULTS)
    t0 = time.perf_counter()
    paths = _write_ctr_parts(CTR_FIELDS, CTR_VOCAB)
    write_s = time.perf_counter() - t0
    main, startup, loss, auc, _, pg = build_deepfm()
    use_vars = [main.global_block().var(n) for n in ("ids", "dense", "label")]
    init = _startup_state(pt, main, startup)
    names = sorted(init)

    def make_ds(bound):
        ds = StreamingDataset(ordered=True)
        for p in paths:
            ds.add_source(FileTailSource(p, name=os.path.basename(p)))
        ds.set_use_var(use_vars)
        ds.set_batch_size(CTR_BATCH)
        ds.set_bad_sample_policy("quarantine",
                                 dead_letter_path=os.path.join(workdir, "dead_letters.jsonl"))
        ds.set_epoch_bound(steps=bound)
        return ds

    def guarded(ck_dir, fault_spec, n_steps, scope, exe, ds=None, start=0, ck=None):
        """Steps under the guardian until ``n_steps`` batches or a
        preemption: (step times, Preempted or None, the checkpointer, the
        dataset, the guardian)."""
        ck = ck or Checkpointer(exe, main, ck_dir, save_interval_steps=save_every,
                                async_save=True)
        g = recovery.StepGuardian(exe, main, checkpointer=ck, start_step=start)
        ds = ds or make_ds(n_steps)
        times, pre = [time.perf_counter()], None
        if fault_spec:
            faults.install(fault_spec)
        try:
            with pt.scope_guard(scope):
                g.train_from_dataset(dataset=ds, fetch_list=[loss, auc],
                                     step_cb=lambda n, last: times.append(time.perf_counter()))
        except recovery.Preempted as e:
            pre = e
        finally:
            faults.clear()
        return times, pre, ck, ds, g

    def fresh():
        scope = pt.Scope()
        for n, t in init.items():
            scope.set_var(n, t.clone())
        main._rng_run_counter = 0
        return scope, pt.Executor()

    recovery.clear_preemption()
    # the uninterrupted run (the same faults, no preemption)
    scope_u, exe_u = fresh()
    _zero_launches()
    before_hist = {h: _hist_totals(h) for h in ("checkpoint_blocked_seconds",
                                                 "checkpoint_write_seconds")}
    times, pre, ck_u, ds_u, g_u = guarded(os.path.join(workdir, "ck_uninterrupted"), spec,
                                          steps, scope_u, exe_u)
    ck_u.wait()
    torch.cuda.synchronize()
    wall_u = times[-1] - times[0]
    launches_u = multi_tensor.multi_tensor_update.launches
    records = ds_u.stream_state()["records"]
    dead = ds_u.stream_state()["dead_letters"]
    step_ms = [(b - a) * 1e3 for a, b in zip(times, times[1:])]
    hist = {h: _hist_delta(before_hist[h], _hist_totals(h)) for h in before_hist}
    final_u = {n: scope_u.find_var(n).clone() for n in names}
    counter_u = main._rng_run_counter
    if pre is not None:
        raise SystemExit(f"stream A: the uninterrupted run was preempted: {pre}")

    # a restore into the live, captured scope: in place, no recapture
    graphs_before = {k: id(s.graph) for k, s in exe_u._cache.items()}
    latest = ck_u.latest_step()
    t0 = time.perf_counter()
    with pt.scope_guard(scope_u):
        restored_live = ck_u.restore()
    live_restore_s = time.perf_counter() - t0
    ds_live = make_ds(steps - restored_live - 1)
    ds_live.seek(ck_u.train_state["stream"])
    with pt.scope_guard(scope_u):
        for feed in ds_live._iter_batches():
            exe_u.run(main, feed=feed, fetch_list=[loss, auc])
    live_again = len(_state_equal(torch, {n: scope_u.find_var(n) for n in names}, final_u))
    graphs_after = {k: id(s.graph) for k, s in exe_u._cache.items()}
    g_u.close()
    del scope_u, exe_u

    # the preempted run, then a fresh executor and dataset that restore and seek
    _zero_launches()
    scope_p, exe_p = fresh()
    _, pre, ck_p, _, _ = guarded(os.path.join(workdir, "ck_preempted"),
                                 spec + f";preempt:step={preempt}", steps, scope_p, exe_p)
    launches_p = multi_tensor.multi_tensor_update.launches
    if pre is None:
        raise SystemExit("stream A: the preempt fault did not preempt the run")
    del scope_p, exe_p
    recovery.clear_preemption()
    scope_r, exe_r = fresh()
    ck_r = Checkpointer(exe_r, main, os.path.join(workdir, "ck_preempted"),
                        save_interval_steps=save_every, async_save=True)
    t0 = time.perf_counter()
    with pt.scope_guard(scope_r):
        restored = ck_r.restore()
    restore_s = time.perf_counter() - t0
    ds_r = make_ds(steps - restored - 1)
    ds_r.seek(ck_r.train_state["stream"])
    _zero_launches()
    with traced([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        times_r, pre_r, _, _, g_r = guarded(None, None, steps, scope_r, exe_r, ds=ds_r,
                                            start=restored + 1, ck=ck_r)
        ck_r.wait()
        torch.cuda.synchronize()
        wall_r = time.perf_counter() - t0
    launches_r = multi_tensor.multi_tensor_update.launches
    busy_ms = _device_busy_ms(prof)
    del prof
    g_r.close()
    final_r = {n: scope_r.find_var(n) for n in names}
    differs = _state_equal(torch, final_r, final_u)
    resume_equal = not differs and main._rng_run_counter == counter_u
    hist_names = [n for n in names if n.startswith("auc")]
    arrival = _arrival_resume(paths, use_vars, guarded, fresh, main, workdir)

    # step 1 against the CPU port, on the stream's first batch
    first = next(iter(make_ds(1)._iter_batches()))
    gaps = _step1_vs_cpu(torch, pt, main, loss, pg, init, first)
    median = statistics.median(step_ms)
    r = dict(model=f"deepfm B{CTR_BATCH} from {len(paths)} FileTailSources (ordered)",
             files=len(paths), write_s=write_s, steps=steps, preempt_at=preempt,
             faults=spec, save_interval_steps=save_every,
             uninterrupted=dict(seconds=wall_u, records=records, dead_letters=dead,
                                records_per_s=records / wall_u, step_ms_median=median,
                                step_ms_max=max(step_ms), multi_tensor_update_launches=launches_u,
                                counter=counter_u),
             deepfm_from_feeds_graph_step_ms=deepfm_step_ms,
             checkpoint=dict(hist, latest_step=latest),
             live_restore=dict(step=restored_live, seconds=live_restore_s,
                               state_differs_after_rerun=live_again,
                               graphs_unchanged=graphs_before == graphs_after,
                               graphs=len(graphs_after)),
             preempted=dict(saved_step=pre.saved_step, step=pre.step,
                            multi_tensor_update_launches=launches_p),
             resumed=dict(restored_step=restored, restore_s=restore_s, seconds=wall_r,
                          steps=len(times_r) - 1, multi_tensor_update_launches=launches_r,
                          device_busy_ms=busy_ms,
                          idle_share_profiled=max(0.0, 1 - busy_ms / (wall_r * 1e3))),
             resume_bit_equal=resume_equal, state_differs=len(differs),
             histograms_equal=all(torch.equal(final_r[n], final_u[n]) for n in hist_names),
             arrival_merge=arrival,
             step1_card_vs_cpu=gaps)
    emit("stream_resume", **r)
    if pre_r is not None:
        raise SystemExit(f"stream A: the resumed run was preempted: {pre_r}")
    if not resume_equal:
        raise SystemExit(f"stream A: the resumed state parts from the uninterrupted run's "
                         f"in {differs[:8]} (counter {main._rng_run_counter} vs {counter_u})")
    if dead != 1:
        raise SystemExit(f"stream A: {dead} records quarantined, expected the 1 corrupt one")
    if launches_u != steps or launches_p + launches_r != steps:
        raise SystemExit(f"stream A: multi_tensor_update launched {launches_u} and "
                         f"{launches_p} + {launches_r} times, expected {steps} a run")
    if live_again or graphs_before != graphs_after:
        raise SystemExit(f"stream A: the in-place restore into the captured scope: "
                         f"{r['live_restore']}")
    if not (gaps["loss_rel_gap"] <= CTR_LOSS_REL and gaps["update_rel_l1_gap"] <= CTR_UPDATE_REL):
        raise SystemExit(f"stream A step 1: card vs CPU {gaps} exceeds the limits")
    return r


def build_ctr_host(pt, vocab, fields=HOST_FIELDS, dim=HOST_DIM, name="ctr_table"):
    """``examples/ctr_deepfm.py``'s program at static shapes: (main, startup,
    loss, params_grads). The host table ``name`` is made anew."""
    from paddle_tpu_torch.ops import host_table
    host_table.drop_table(name)
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = SEED
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        ids = pt.data("ids", [fields], "int64")
        dense = pt.data("dense", [HOST_DENSE], "float32")
        label = pt.data("label", [1], "float32")
        emb = pt.layers.host_embedding(ids, (vocab, dim), name=name, optimizer="adagrad",
                                       learning_rate=0.05, seed=SEED)
        deep = pt.layers.concat([pt.layers.reshape(emb, [-1, fields * dim]), dense], axis=1)
        for width in (256, 128):
            deep = pt.layers.fc(deep, width, act="relu")
        logit = pt.layers.fc(deep, 1)
        loss = pt.layers.mean(pt.layers.sigmoid_cross_entropy_with_logits(logit, label))
        _, pg = pt.optimizer.Adam(1e-3).minimize(loss)
    return main, startup, loss, pg


def ctr_host_feeds(vocab, batch, steps, fields=HOST_FIELDS, seed=SEED):
    """The example's batches: labels drawn from a logistic model of the ids."""
    rng = np.random.RandomState(seed)
    w_true = rng.randn(vocab).astype("float32") * 0.1
    out = []
    for _ in range(steps):
        ids = rng.randint(0, vocab, (batch, fields)).astype("int64")
        dense = rng.rand(batch, HOST_DENSE).astype("float32")
        p = 1 / (1 + np.exp(-w_true[ids].sum(1)))
        out.append({"ids": ids, "dense": dense,
                    "label": (rng.rand(batch) < p).astype("float32")[:, None]})
    return out


def _ctr_host(torch, pt, workdir, vocab, batch, steps, profile=False):
    """Path B of phase 20 at one size; ``profile``: trace a few captured
    steps for the device's busy time."""
    from paddle_tpu_torch.ops import host_table, multi_tensor
    from paddle_tpu_torch.resilience import faults, recovery
    from paddle_tpu_torch.tools.train_profile import traced
    from torch.profiler import ProfilerActivity
    name = f"ctr_table_{vocab}"
    main, startup, loss, pg = build_ctr_host(pt, vocab, name=name)
    table = host_table.get_table(name)
    feeds = ctr_host_feeds(vocab, batch, steps)
    scope0 = pt.Scope()
    with pt.scope_guard(scope0):
        pt.Executor().run(startup)
    init = {n: scope0.find_var(n).clone() for n, v in main.global_block().vars.items()
            if v.persistable and scope0.find_var(n) is not None}
    names = sorted(init)
    t0_dir = os.path.join(workdir, f"table0_{vocab}")
    t0 = time.perf_counter()
    host_table.save_all(t0_dir)
    save_s = time.perf_counter() - t0
    pulls_ms, pushes_ms = [], []
    real_pulls, real_pushes = host_table.run_pulls, host_table.run_pushes

    def timed(fn, acc):
        def wrapped(*a):
            t = time.perf_counter()
            out = fn(*a)
            acc.append((time.perf_counter() - t) * 1e3)
            return out
        return wrapped

    runs = {}
    for path in ("eager", "graph", "graph_fetch_fault"):
        host_table.load_all(t0_dir)
        scope = pt.Scope()
        for n, t in init.items():
            scope.set_var(n, t.clone())
        main._rng_run_counter = 0
        exe = pt.Executor()
        exe._use_graphs = path != "eager"
        step = exe.run
        if path == "graph_fetch_fault":
            # a transient fault after a captured step: the executor undoes
            # the step's update before it raises, the guardian retries it
            faults.install(HOST_FETCH_FAULT)
            step = recovery.StepGuardian(exe, main, retry_backoff=0.001).run
        _zero_launches()
        losses, times = [], []
        if path == "graph":
            host_table.run_pulls = timed(real_pulls, pulls_ms)
            host_table.run_pushes = timed(real_pushes, pushes_ms)
            parts0 = _hist_totals(host_table.PUSH_SECONDS, key="part", table=name)
        try:
            with pt.scope_guard(scope):
                t_start = time.perf_counter()
                for f in feeds:
                    losses.append(step(main, feed=f, fetch_list=[loss])[0])
                    times.append(time.perf_counter())
        finally:
            host_table.run_pulls, host_table.run_pushes = real_pulls, real_pushes
            fired = [f.fired for f in faults.active()]
            faults.clear()
        if path == "graph":
            # HostTable._apply's own spans: the mean ms a push of each part
            push_parts = {part: d["seconds_mean"] * 1e3 for part, d in _hist_delta(
                parts0, _hist_totals(host_table.PUSH_SECONDS, key="part", table=name)).items()}
        step_ms = [(b - a) * 1e3 for a, b in zip([t_start] + times, times)]
        runs[path] = dict(losses=losses, state={n: scope.find_var(n).clone() for n in names},
                          table=table.table.copy(), accum=table._accum.copy(),
                          push_count=table.push_count, step_ms=step_ms, fired=fired,
                          launches=multi_tensor.multi_tensor_update.launches)
        if path == "graph":
            refused = None
            try:
                exe.run_fused(main, feeds=feeds[:2], fetch_list=[loss])
            except ValueError as e:
                refused = str(e)
            busy = wall = None
            if profile:
                with pt.scope_guard(scope), traced([ProfilerActivity.CPU,
                                                    ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    for f in feeds[:HOST_PROFILED_STEPS]:
                        exe.run(main, feed=f, fetch_list=[loss])
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                busy = _device_busy_ms(prof) / HOST_PROFILED_STEPS
                del prof
            captures = sum(s.graph is not None for s in exe._cache.values())
        exe.close()
    g, e, ff = runs["graph"], runs["eager"], runs["graph_fetch_fault"]

    def same(a, b):
        return (all(np.array_equal(x, y) for x, y in zip(a["losses"], b["losses"]))
                and not _state_equal(torch, a["state"], b["state"])
                and np.array_equal(a["table"], b["table"])
                and np.array_equal(a["accum"], b["accum"]) and a["push_count"] == b["push_count"])
    bit_equal = same(g, e)
    retry_equal = same(ff, g) and ff["fired"] == [1]

    # save_all / load_all round trip
    host_table.load_all(t0_dir)
    table.table[:], table._accum[:], table.push_count = g["table"], g["accum"], g["push_count"]
    rt_dir = os.path.join(workdir, f"table1_{vocab}")
    host_table.save_all(rt_dir)
    table.table[:] = 0
    table._accum[:] = 0
    t0 = time.perf_counter()
    host_table.load_all(rt_dir)
    load_s = time.perf_counter() - t0
    round_trip = (np.array_equal(table.table, g["table"]) and np.array_equal(table._accum, g["accum"])
                  and table.push_count == g["push_count"])

    # step 1 against the CPU port: the dense update and the table's update
    ups = {}
    for dev in ("cuda", "cpu"):
        host_table.load_all(t0_dir)
        before = table.table.copy()
        feed = feeds[0] if dev == "cpu" else {k: torch.from_numpy(v).cuda()
                                              for k, v in feeds[0].items()}
        ups[dev] = _step_once(torch, pt, main, loss, [p.name for p, _ in pg], init, feed, dev)
        ups[dev][1]["@table"] = torch.from_numpy(table.table - before)
    gaps = dict(_gaps(ups["cuda"], ups["cpu"]), loss_rel_limit=CTR_LOSS_REL,
                update_rel_l1_limit=CTR_UPDATE_REL)
    losses = [float(np.asarray(x).reshape(-1)[0]) for x in g["losses"]]
    k = max(1, len(losses) // 8)
    r = dict(model=f"ctr_deepfm host_embedding({vocab} x {HOST_DIM}, adagrad 0.05) "
                   f"256-128 Adam(1e-3) B{batch} fields {HOST_FIELDS}",
             steps=steps, table_mb=table.table.nbytes / 1e6, accum_mb=table._accum.nbytes / 1e6,
             loss_first=float(np.mean(losses[:k])), loss_last=float(np.mean(losses[-k:])),
             graph_eager_bit_equal=bit_equal, push_count=g["push_count"],
             fetch_fault=HOST_FETCH_FAULT, fetch_fault_retry_bit_equal=retry_equal,
             step_ms={p: statistics.median(runs[p]["step_ms"][1:]) for p in runs},
             gather_ms_median=statistics.median(pulls_ms),
             push_ms_median=statistics.median(pushes_ms), push_parts_ms=push_parts,
             device_busy_ms_per_step=busy,
             idle_share_profiled=(max(0.0, 1 - busy * HOST_PROFILED_STEPS / (wall * 1e3))
                                  if busy is not None else None),
             run_fused_refused=refused, graphs_captured=captures,
             multi_tensor_update_launches={p: runs[p]["launches"] for p in runs},
             save_all_s=save_s, load_all_s=load_s, save_load_round_trip=round_trip,
             step1_card_vs_cpu=gaps)
    host_table.drop_table(name)
    if not bit_equal:
        raise SystemExit(f"ctr host table B{batch}: graph and eager parted")
    if not retry_equal:
        raise SystemExit(f"ctr host table B{batch}: the run with {HOST_FETCH_FAULT} retried "
                         f"(fired {ff['fired']}) parted from the clean graph run")
    if not (g["push_count"] == e["push_count"] == steps):
        raise SystemExit(f"ctr host table: push_count {g['push_count']}, {e['push_count']}")
    if refused is None or "host-table pulls/pushes (PS schedule)" not in refused:
        raise SystemExit(f"ctr host table: run_fused was not refused for the JAX reason: "
                         f"{refused}")
    if not round_trip:
        raise SystemExit("ctr host table: save_all / load_all did not round-trip")
    # the faulted step launches twice: its undone attempt and its retry
    if not (e["launches"] == g["launches"] == steps and ff["launches"] == steps + 1):
        raise SystemExit(f"ctr host table: multi_tensor_update launches "
                         f"{r['multi_tensor_update_launches']}, expected {steps} a path "
                         f"({steps + 1} with the fetch fault)")
    if not all(np.isfinite(losses)):
        raise SystemExit("ctr host table: a loss is not finite")
    if not (gaps["loss_rel_gap"] <= CTR_LOSS_REL and gaps["update_rel_l1_gap"] <= CTR_UPDATE_REL):
        raise SystemExit(f"ctr host table step 1: card vs CPU {gaps} exceeds the limits")
    return r


def phase_stream_and_host_table(torch, workdir, deepfm_step_ms=None):
    """Phase 20: A (DeepFM from a stream, preempted and resumed) and B
    (``examples/ctr_deepfm.py``'s program at its constants and at A's
    scale)."""
    import paddle_tpu_torch as pt
    t0 = time.perf_counter()
    a = _stream_resume(torch, pt, workdir, deepfm_step_ms)
    torch.cuda.empty_cache()
    b1 = _ctr_host(torch, pt, workdir, **CTR_EXAMPLE)
    b2 = _ctr_host(torch, pt, workdir, **CTR_AT_SCALE, profile=True)
    emit("ctr_host_table", example=b1, at_scale=b2)
    if not b1["loss_last"] < b1["loss_first"]:
        raise SystemExit(f"ctr host table at the example's constants: the loss does not "
                         f"fall: {b1['loss_first']} -> {b1['loss_last']}")
    emit("stream_and_host_table", seconds=time.perf_counter() - t0)
    return a, b1, b2


def phase_main_path(torch, workdir):
    """The serving path (phase 4)."""
    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import flash_attention
    from paddle_tpu_torch.tools.serving_profile import bert_feed, save_bert_encoder

    cfg = bert.BertConfig(dtype="bfloat16")   # L12 H768 A12, FFN 3072, vocab 30522, S<=512
    model_dir = os.path.join(workdir, "bert_base")
    t0 = time.perf_counter()
    save_bert_encoder(model_dir, cfg, SEED)    # startup on the card
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = Predictor(model_dir)                # the card
    load_s = time.perf_counter() - t0
    n_params = sum(int(np.prod(v.shape)) for v in pred._state.values())

    rng = np.random.RandomState(SEED)
    requests = [bert_feed(rng, B, S, cfg.vocab_size) for B, S in BERT_REQUESTS]
    warm_rng = np.random.RandomState(SEED + 1)
    for B, S in sorted(set(BERT_REQUESTS)):    # first use of each shape: allocator, cuBLAS
        pred.run(bert_feed(warm_rng, B, S, cfg.vocab_size))
    torch.cuda.synchronize()

    flash_attention.flash_attn_fwd.launches = 0
    outs, lat = [], []
    for feed in requests:
        t0 = time.perf_counter()
        outs.append(pred.run(feed)[0])         # numpy: the device work is done
        lat.append(time.perf_counter() - t0)
    launches = {"flash_attn_fwd": flash_attention.flash_attn_fwd.launches}

    expected = cfg.n_layers * len(requests)
    for (B, S), o in zip(BERT_REQUESTS, outs):
        if o.shape != (B, S, cfg.hidden) or not np.isfinite(o).all():
            raise SystemExit(f"bad output {o.shape} finite={np.isfinite(o).all()}")
    if launches["flash_attn_fwd"] != expected:
        raise SystemExit(f"flash_attn_fwd launched {launches['flash_attn_fwd']} times on "
                         f"the main path, expected {expected}")
    modes = phase_serving_modes(torch, "serving", model_dir, pred, requests, outs, lat,
                                "flash_attn_fwd", "flash_fwd_bf16_kernel")

    # references for the first request: the plain attention on the card, and
    # the whole plain path on the CPU
    card_plain = Predictor(model_dir)
    for op in card_plain.program.global_block().ops:
        if op.type == "fused_attention":
            op.attrs["impl"] = "composed"
    plain_out = card_plain.run(requests[0])[0]
    del card_plain
    t0 = time.perf_counter()
    cpu_out = Predictor(model_dir, device="cpu").run(requests[0])[0]
    cpu_s = time.perf_counter() - t0
    gaps = {}
    for name, a, b in (("kernel_vs_card_plain", outs[0], plain_out),
                       ("card_plain_vs_cpu_plain", plain_out, cpu_out),
                       ("card_vs_cpu_plain", outs[0], cpu_out)):
        d = np.abs(a - b)
        gaps[name] = dict(max_abs=float(d.max()), mean_abs=float(d.mean()))
    e2e = dict(gaps, max_abs_limit=E2E_MAX_ABS, mean_abs_limit=E2E_MEAN_ABS,
               mean_abs_output=float(np.abs(cpu_out).mean()), cpu_seconds=cpu_s)
    per_req = [dict(batch=B, seq=S, ms=s * 1e3, tokens_per_s=B * S / s)
               for (B, S), s in zip(BERT_REQUESTS, lat)]
    model = (f"bert encoder L{cfg.n_layers} H{cfg.hidden} A{cfg.n_heads} "
             f"FFN{cfg.ffn_hidden} vocab{cfg.vocab_size} {cfg.dtype}")
    emit("main_path", model=model, params=n_params,
         build_startup_save_s=build_s, predictor_load_s=load_s, requests=per_req,
         launches=launches, expected_launches={"flash_attn_fwd": expected},
         first_request_gaps=e2e)
    for name in ("kernel_vs_card_plain", "card_plain_vs_cpu_plain"):
        g = gaps[name]
        if not (g["max_abs"] <= E2E_MAX_ABS and g["mean_abs"] <= E2E_MEAN_ABS):
            raise SystemExit(f"main path output: {name} gap {g} exceeds the limits")
    return launches, modes


# ---------------------------------------------------------------------------------------
# phase 21: the serving tier and the tuner
# ---------------------------------------------------------------------------------------

# K1-fwd's two query tiles, at serving's configuration (bias, no dropout, no LSE)
K1_TILE_SHAPES = ((8, 12, 512, 64), (128, 12, 128, 64))


def _k1_tiles(torch):
    """K1-fwd at both query tiles (``block_q`` 128 and 64) against
    ``attention_plain`` on the same inputs, with CUDA-event times beside the
    bound; the two tiles run the same arithmetic per row, so their outputs
    are compared bit for bit too."""
    from paddle_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    rows = []
    for B, H, S, D in K1_TILE_SHAPES + ((2, 4, 200, 32),):
        q, k, v, bias = _attn_inputs(torch, B, H, S, D, torch.bfloat16, True, gen)
        scale = 1.0 / D ** 0.5
        ref = fa.attention_plain(q, k, v, bias, scale, False)
        outs = {}
        for bq in fa.FWD_BLOCK_Q:
            outs[bq] = fa.flash_attn_fwd(q, k, v, bias, scale, False, block_q=bq)
            err = (outs[bq].float() - ref.float()).abs().max().item()
            ms = _device_ms(torch, lambda bq=bq: fa.flash_attn_fwd(q, k, v, bias, scale, False,
                                                                    block_q=bq))
            bound_ms, bound_by = _bound(B, H, S, D, "bfloat16", True, False, 2)
            r = dict(shape=[B, H, S, D], block_q=bq, max_abs_err=err, atol=ATOL["bfloat16"],
                     finite=bool(torch.isfinite(outs[bq]).all()), ms=ms, bound_ms=bound_ms,
                     bound_by=bound_by)
            rows.append(r)
        same = torch.equal(outs[64], outs[128])
        plain_ms = _device_ms(torch, lambda: fa.attention_plain(q, k, v, bias, scale, False))
        library_ms = _device_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=bias, scale=scale))
        for r in rows[-2:]:
            r.update(plain_ms=plain_ms, library_ms=library_ms, tiles_bit_equal=same)
            emit("serving_tier_k1_tile", **r)
    bad = [r for r in rows if not (r["finite"] and r["max_abs_err"] <= r["atol"]
                                   and r["tiles_bit_equal"])]
    if bad:
        raise SystemExit(f"flash_attn_fwd's tiles disagree with attention_plain or with "
                         f"each other: {bad}")
    return rows


# phase 21's pool (C): PredictorPool(size=2, max_batch=8, max_wait_ms=2.0) over
# BERT-base (phase 4's model); 8 client threads, tenants t0/t1/t2 at weights 1/1/2
POOL_SIZE, POOL_MAX_BATCH, POOL_MAX_WAIT_MS = 2, 8, 2.0
POOL_CLIENTS, POOL_REQUESTS, POOL_LONG_REQUESTS = 8, 10, 2
POOL_WEIGHTS = {"t0": 1.0, "t1": 1.0, "t2": 2.0}
# a batched row against the solo run of its request: at most 1 bf16 ULP at the
# scale of its token's hidden vector (serving/__main__.ulps_apart): cuBLAS may
# sum a product in another order at another M, one rounding apart
POOL_SOLO_ULPS = 1.0
# 3.19 on the card: (row, k) -> jax.lax.top_k's indices (tests/test_torch_ops.py
# holds the same rows against jax.lax.top_k on the CPU)
TOPK_ROWS = ((((-0.0, 0.0),), 1, [[1]]),
             (((1.0, -0.0, 0.0, -1.0),), 2, [[0, 2]]),
             (((1.0, -float("nan"), -1.0, 0.0),), 2, [[0, 3]]))
# 3.11 on the card: an out-of-range gather, in a child process (a device-side
# assert ends the CUDA context of the process that raised it)
GATHER_PROBE = (
    "import torch, paddle_tpu_torch\n"
    "from paddle_tpu_torch.core import registry\n"
    "x = torch.arange(12., device='cuda').reshape(4, 3)\n"
    "idx = torch.tensor([[1], [7]], device='cuda')\n"
    "out = registry.get('gather').lower(registry.LowerCtx({'axis': 0}),"
    " {'X': [x], 'Index': [idx]})['Out'][0]\n"
    "print('returned', out.cpu().tolist(), flush=True)\n")


def _bert_program(pt, cfg, S):
    """BERT-base's serving program at S tokens (the encoder as
    ``serving_profile.save_bert_encoder`` builds it, with ``is_test`` set as
    ``save_inference_model`` sets it), for ``tune_program``."""
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.tools.serving_profile import FEEDS
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        feeds = [pt.data(n, [S], dt) for n, dt in FEEDS]
        bert.encoder(*feeds, cfg)
    return main.clone(for_test=True)


def _decisions(label, entries):
    rows = [dict(choice=e["choice"], key=e["key"], winner=e["winner"], source=e["source"],
                 timings={c: t.get("run_ms", t) for c, t in (e.get("timings") or {}).items()})
            for e in entries]
    for r in rows:
        emit("serving_tier_decision", program=label, **r)
    return rows


def _tuner(torch, pt):
    """A: ``tune_program`` in search over BERT-base's serving program (bf16, S
    128 and 512, the pool's row buckets) and ResNet-50's training program."""
    from paddle_tpu_torch import tuning
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.tools.train_profile import build_resnet50
    t0 = time.perf_counter()
    out = {}
    for S in (128, 512):
        prog = _bert_program(pt, BertConfig(dtype="bfloat16", max_seq_len=S), S)
        entries = []
        for rows in (1, 2, 4, POOL_MAX_BATCH):
            entries += tuning.tune_program(prog, batch=rows, mode="search")
        out[f"bert_base_s{S}"] = _decisions(f"bert_base_s{S}", entries)
    resnet = build_resnet50()[0]
    out["resnet50"] = _decisions("resnet50", tuning.tune_program(resnet, batch=RESNET_BATCH,
                                                                 mode="search"))
    kinds = {}
    for label, rows in out.items():
        for r in rows:
            kinds.setdefault(f"{label}:{r['choice']}", []).append(r["winner"])
    emit("serving_tier_tuner", seconds=time.perf_counter() - t0,
         decisions={k: {w: v.count(w) for w in sorted(set(v))} for k, v in kinds.items()},
         measured=sum(1 for rows in out.values() for r in rows if r["source"] == "search"))
    bad = [r for rows in out.values() for r in rows if r["source"] not in ("search", "cached")]
    if bad:
        raise SystemExit(f"tune_program did not measure every choice point: {bad[:3]}")
    return out


def _fuse_search(torch, pt, workdir):
    """B: ``train_from_dataset(fuse_steps=0)`` under search on phase 15's
    DeepFM part files, then ``fuse_steps=K`` at the K it picked, from the same
    state: the parameters bit for bit."""
    from paddle_tpu_torch.tools.train_profile import CTR_BATCH, CTR_FIELDS, CTR_VOCAB, build_deepfm
    from paddle_tpu_torch.tuning import cache as tcache
    paths = _write_ctr_parts(CTR_FIELDS, CTR_VOCAB)
    main, startup, loss, auc, prob, _ = build_deepfm()
    use_vars = [main.global_block().var(n) for n in ("ids", "dense", "label")]
    init = _startup_state(pt, main, startup)

    def epoch(fuse_steps):
        ds = pt.DatasetFactory().create_dataset("QueueDataset")
        ds.set_batch_size(CTR_BATCH)
        ds.set_thread(E2E_THREADS)
        ds.set_use_var(use_vars)
        ds.set_filelist(paths)
        ds.drop_last = True
        scope = pt.Scope()
        for n, t in init.items():
            scope.set_var(n, t.clone())
        main._rng_run_counter = 0
        exe = pt.Executor()
        t0 = time.perf_counter()
        with pt.scope_guard(scope):
            exe.train_from_dataset(main, ds, fetch_list=[loss, auc], fuse_steps=fuse_steps)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        state = {n: scope.find_var(n).clone() for n in init}
        exe.close()
        return state, seconds, main._rng_run_counter

    old = os.environ.get("PADDLE_TPU_TUNE")
    os.environ["PADDLE_TPU_TUNE"] = "search"
    try:
        searched, search_s, steps = epoch(0)
    finally:
        if old is None:
            os.environ.pop("PADDLE_TPU_TUNE")
        else:
            os.environ["PADDLE_TPU_TUNE"] = old
    recs = [r for r in tcache.CACHE.items().values() if r.get("choice") == "fuse_steps.k"]
    if len(recs) != 1 or not recs[0]["measured"]:
        raise SystemExit(f"fuse_steps=0 did not persist one measured decision: {recs}")
    k = int(recs[0]["winner"])
    fixed, fixed_s, fixed_steps = epoch(k)
    equal = not _state_equal(torch, searched, fixed)
    r = dict(k=k, timings_ms_per_step={c: t.get("run_ms") for c, t in recs[0]["timings"].items()},
             search_seconds=recs[0]["search_seconds"], steps=steps, search_epoch_s=search_s,
             fixed_k_epoch_s=fixed_s, state_bit_equal=equal)
    emit("serving_tier_fuse_steps", **r)
    if not equal or steps != fixed_steps:
        raise SystemExit(f"fuse_steps=0 parted from fuse_steps={k}: {r}")
    return r


def _k1_launches():
    from paddle_tpu_torch.ops import flash_attention as fa
    return fa.flash_attn_fwd.launches + fa.flash_attn_fwd_q64.launches


def _pool_traffic(torch, pool, feeds, label):
    """Every client thread submits its feeds in turn (``tenant``, feed) and
    waits for each answer; returns (outputs, latencies s, wall s)."""
    import threading
    outs, lat = {}, {}
    errors = []

    def client(c):
        try:
            for i, (tenant, feed) in enumerate(feeds[c]):
                t0 = time.perf_counter()
                outs[(c, i)] = pool.run(feed, tenant=tenant, timeout=120)[0]
                lat[(c, i)] = time.perf_counter() - t0
        except BaseException as e:  # noqa: BLE001 -- raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(len(feeds))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise SystemExit(f"{label}: a client failed: {errors[:2]}")
    return outs, lat, wall


def _against_solo(solo, feeds, outs, hidden):
    """Each output against the solo run of its feed: byte-equal count and the
    farthest distance in bf16 ULPs at each token's scale."""
    from paddle_tpu_torch.serving.__main__ import ulps_apart
    equal, worst = 0, 0.0
    for (c, i), out in outs.items():
        ref = solo[(c, i)]
        equal += out.tobytes() == ref.tobytes()
        worst = max(worst, ulps_apart(out.reshape(-1, hidden), ref.reshape(-1, hidden),
                                      "bfloat16"))
    return equal, worst


def _serving_pool(torch, pt, workdir):
    """C: BERT-base behind ``PredictorPool``: warmup, traffic against solo
    runs, launches and captures, hot swap under load, a faulted tenant,
    ``dtype='auto'`` under search, and the drain."""
    import threading
    from torch.profiler import ProfilerActivity
    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.observability import journal
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.serving import BreakerOpen, PredictorPool, ServingError
    from paddle_tpu_torch.tools.serving_profile import bert_feed, save_bert_encoder
    from paddle_tpu_torch.tools.train_profile import traced
    cfg = BertConfig(dtype="bfloat16")
    model_a, model_b = os.path.join(workdir, "bert_a"), os.path.join(workdir, "bert_b")
    save_bert_encoder(model_a, cfg, SEED)
    save_bert_encoder(model_b, cfg, SEED + 1)
    rng = np.random.RandomState(SEED + 21)
    tenants = sorted(POOL_WEIGHTS)
    feeds = []
    for c in range(POOL_CLIENTS):
        mine = [(tenants[(c + i) % 3], bert_feed(rng, int(rng.randint(1, POOL_MAX_BATCH + 1)),
                                                 128, cfg.vocab_size))
                for i in range(POOL_REQUESTS)]
        mine += [(tenants[c % 3], bert_feed(rng, int(rng.randint(1, 3)), 512, cfg.vocab_size))
                 for _ in range(POOL_LONG_REQUESTS)]
        feeds.append(mine)
    solo_pred = Predictor(model_a)
    solo = {(c, i): solo_pred.run(f)[0] for c, mine in enumerate(feeds)
            for i, (_, f) in enumerate(mine)}

    pool = PredictorPool(model_a, size=POOL_SIZE, max_batch=POOL_MAX_BATCH,
                         max_wait_ms=POOL_MAX_WAIT_MS, weights=POOL_WEIGHTS)
    try:
        t0 = time.perf_counter()
        warmed = pool.warmup(feeds[0][0][1])           # S 128's buckets only
        warmup_s = time.perf_counter() - t0
        # a cold signature captured beside live replays: three clients replay S 128
        # while a fourth sends S 512 requests, which a worker captures (thread_local)
        misses = [p._cache_counts["miss"] for p in pool._predictors]
        cold_idx = [[(c, i) for i in range(4)] for c in range(3)] \
            + [[(3, POOL_REQUESTS + j) for j in range(POOL_LONG_REQUESTS)]]
        cold_feeds = [[feeds[c][i] for c, i in idx] for idx in cold_idx]
        cold_outs, _, _ = _pool_traffic(torch, pool, cold_feeds, "cold-signature traffic")
        cold_equal, cold_worst = _against_solo(
            {(k, j): solo[cold_idx[k][j]] for k in range(4) for j in range(len(cold_idx[k]))},
            cold_feeds, cold_outs, cfg.hidden)
        cold = dict(requests=len(cold_outs), byte_equal_to_solo=cold_equal,
                    max_ulps_to_solo=cold_worst,
                    graphs_captured=[p._cache_counts["miss"] - m
                                     for p, m in zip(pool._predictors, misses)])
        emit("serving_tier_cold_signature", **cold)
        if cold_worst > POOL_SOLO_ULPS or not sum(cold["graphs_captured"]):
            raise SystemExit(f"a signature captured beside live replays broke: {cold}")
        t0 = time.perf_counter()
        warmed += pool.warmup(feeds[0][-1][1])         # the rest of S 512's buckets
        warmup_s += time.perf_counter() - t0
        graphs = [len(p._compiled) for p in pool._predictors]
        misses = [p._cache_counts["miss"] for p in pool._predictors]
        per_replay = {k.__name__: v for p in pool._predictors for exe in p._compiled.values()
                      for k, v in exe.launches.items()}
        k1_per_replay = sorted({sum(n for f, n in exe.launches.items()
                                    if f.__name__.startswith("flash_attn_fwd"))
                                for p in pool._predictors for exe in p._compiled.values()})
        torch.cuda.synchronize()
        from paddle_tpu_torch.core import cuda_build
        for f in cuda_build.COUNTED:
            f.launches = 0
        with traced([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            outs, lat, wall = _pool_traffic(torch, pool, feeds, "pool traffic")
            torch.cuda.synchronize()
        launches = {f.__name__: f.launches for f in cuda_build.COUNTED if f.launches}
        busy_ms = _device_busy_ms(prof)
        new_graphs = [p._cache_counts["miss"] - m for p, m in zip(pool._predictors, misses)]
        equal, worst = _against_solo(solo, feeds, outs, cfg.hidden)
        ms = sorted(v * 1e3 for v in lat.values())
        traffic = dict(requests=len(outs), rows=int(sum(o.shape[0] for o in outs.values())),
                       byte_equal_to_solo=equal, max_ulps_to_solo=worst,
                       p50_ms=ms[len(ms) // 2], p99_ms=ms[min(len(ms) - 1,
                                                              int(0.99 * len(ms)))],
                       requests_per_s=len(outs) / wall, wall_s=wall, device_busy_ms=busy_ms,
                       idle_share=max(0.0, 1.0 - busy_ms / (wall * 1e3)),
                       launches=launches, k1_fwd_launches_per_replay=k1_per_replay,
                       graphs_per_worker=graphs, graphs_captured_in_traffic=new_graphs,
                       warmup_s=warmup_s, warmed=warmed, launches_per_replay_kinds=per_replay)
        emit("serving_tier_pool", **traffic)
        if worst > POOL_SOLO_ULPS or new_graphs != [0] * POOL_SIZE \
                or k1_per_replay != [cfg.n_layers] or graphs != [8] * POOL_SIZE:
            raise SystemExit(f"the pool's traffic broke a check: {traffic}")

        # hot swap under load: model B copied into the pinned tensors while 4
        # clients keep sending S 128 requests; each output equals (within
        # POOL_SOLO_ULPS) one model's solo output, and every request sent after
        # swap() returned gets model B's
        from paddle_tpu_torch.serving.__main__ import ulps_apart
        misses = [p._cache_counts["miss"] for p in pool._predictors]
        swap_feeds = [[f for _, f in mine[:POOL_REQUESTS]] for mine in feeds[:4]]
        stop = threading.Event()
        served_log = []

        def swap_client(c):
            i = 0
            while not stop.is_set():
                f = swap_feeds[c][i % len(swap_feeds[c])]
                t_sub = time.perf_counter()
                served_log.append((c, i % len(swap_feeds[c]), t_sub,
                                   pool.run(f, tenant="t0", timeout=120)[0]))
                i += 1

        clients = [threading.Thread(target=swap_client, args=(c,)) for c in range(4)]
        for t in clients:
            t.start()
        time.sleep(0.2)
        t0 = time.perf_counter()
        version = pool.swap(model_b, timeout=120)
        t_swapped = time.perf_counter()
        time.sleep(0.2)
        stop.set()
        for t in clients:
            t.join(timeout=120)
        solo_a = {(c, i): solo[(c, i)] for c in range(4) for i in range(POOL_REQUESTS)}
        solo_pred.swap_state({n: t.clone() for n, t in pool._predictors[0]._state.items()})
        solo_b = {(c, i): solo_pred.run(swap_feeds[c][i])[0] for c in range(4)
                  for i in range(POOL_REQUESTS)}
        served = {"old": 0, "new": 0, "after_swap_old": 0}
        for c, i, t_sub, out in served_log:
            for name, ref in (("new", solo_b[(c, i)]), ("old", solo_a[(c, i)])):
                if ulps_apart(out.reshape(-1, cfg.hidden), ref.reshape(-1, cfg.hidden),
                              "bfloat16") <= POOL_SOLO_ULPS:
                    served[name] += 1
                    served["after_swap_old"] += name == "old" and t_sub > t_swapped
                    break
            else:
                raise SystemExit("a swap-time output equals neither model's solo output")
        swap = dict(model_version=version, swap_s=t_swapped - t0, served=served,
                    graphs_captured=[p._cache_counts["miss"] - m
                                     for p, m in zip(pool._predictors, misses)])
        emit("serving_tier_swap", **swap)
        if swap["graphs_captured"] != [0] * POOL_SIZE or version != 2 \
                or not served["old"] or not served["new"] or served["after_swap_old"]:
            raise SystemExit(f"the hot swap captured a graph, tore or did not finish: {swap}")

        # chaos: exc@serve_dispatch on tenant evil; its breaker opens, the rest is served
        faults.clear()
        journal.clear()
        faults.install("exc@serve_dispatch:var=evil:times=0")
        evil = {"typed": 0, "breaker_open": 0}
        try:
            for _ in range(pool._breaker.threshold + 3):
                try:
                    pool.run(feeds[0][0][1], tenant="evil", timeout=120)
                except BreakerOpen:
                    evil["breaker_open"] += 1
                except ServingError:
                    evil["typed"] += 1
            good, _, _ = _pool_traffic(torch, pool, [mine[:3] for mine in feeds[:4]],
                                       "chaos traffic")
        finally:
            faults.clear()
        opened = [e["tenant"] for e in journal.recent(event="serve_breaker")
                  if e["to"] == "open"]
        chaos = dict(evil=evil, breaker_opened_for=opened, good_served=len(good),
                     good_requests=sum(len(m[:3]) for m in feeds[:4]))
        emit("serving_tier_chaos", **chaos)
        if evil["typed"] != pool._breaker.threshold or evil["breaker_open"] != 3 \
                or opened != ["evil"] or chaos["good_served"] != chaos["good_requests"]:
            raise SystemExit(f"the faulted tenant's errors were not contained: {chaos}")
        t0 = time.perf_counter()
        pool.close(drain_timeout=30.0)
        close_s = time.perf_counter() - t0
    finally:
        pool.close(drain_timeout=30.0)
        faults.clear()

    # dtype="auto" under search: each row bucket's serving.dtype decision
    old = os.environ.get("PADDLE_TPU_TUNE")
    os.environ["PADDLE_TPU_TUNE"] = "search"
    auto = PredictorPool(model_a, size=1, max_batch=POOL_MAX_BATCH,
                         max_wait_ms=POOL_MAX_WAIT_MS, dtype="auto")
    try:
        auto.warmup(feeds[0][0][1])
    finally:
        auto.close(drain_timeout=30.0)
        if old is None:
            os.environ.pop("PADDLE_TPU_TUNE")
        else:
            os.environ["PADDLE_TPU_TUNE"] = old
    from paddle_tpu_torch.tuning import cache as tcache
    dtype_dec = {json.loads(k.split("|")[1])["rows"]: dict(
        winner=r["winner"], ms={c: t.get("run_ms", t) for c, t in r["timings"].items()})
        for k, r in tcache.CACHE.items().items() if r.get("choice") == "serving.dtype"}
    emit("serving_tier_dtype", decisions=dtype_dec, close_s=close_s)
    if sorted(dtype_dec) != [1, 2, 4, 8] or any(
            isinstance(t, dict) for d in dtype_dec.values() for t in d["ms"].values()):
        raise SystemExit(f"serving.dtype did not measure every candidate of every bucket: "
                         f"{dtype_dec}")
    return dict(traffic=traffic, cold=cold, swap=swap, chaos=chaos, dtype=dtype_dec,
                close_s=close_s)


def _port_faults_on_card(torch):
    """3.19's rows through ``top_k`` on the card, and 3.11: an out-of-range
    gather on the card, in a child process."""
    from paddle_tpu_torch.core import registry
    topk = []
    for row, k, want in TOPK_ROWS:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.tensor(row, dtype=torch.float32, device="cuda")
            if dt == torch.bfloat16:       # the top half of the bits: exact, NaN's sign kept
                x = (x.view(torch.int32) >> 16).to(torch.int16).view(torch.bfloat16)
            got = registry.get("top_k").lower(registry.LowerCtx({"k": k}), {"X": [x]})
            topk.append(dict(row=[str(v) for v in row[0]], dtype=str(dt), k=k,
                             indices=got["Indices"][0].tolist(), want=want))
    r = subprocess.run([sys.executable, "-c", GATHER_PROBE], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    tail = [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
            if "Assertion" in ln or "Error" in ln or ln.startswith("returned")][-3:]
    gather = dict(returncode=r.returncode, tail=tail,
                  device_assert="device-side assert" in r.stderr)
    emit("serving_tier_port_faults", top_k=topk, out_of_range_gather=gather)
    bad = [t for t in topk if t["indices"] != t["want"]]
    if bad:
        raise SystemExit(f"top_k parted from jax.lax.top_k on the card: {bad}")
    return dict(top_k=topk, gather=gather)


def phase_serving_tier(torch, workdir):
    """Phase 21: the tuner (A), fuse_steps=0 (B), the serving pool (C), the
    port's fault probes on the card."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import cuda_build
    t0 = time.perf_counter()
    tiles = _k1_tiles(torch)
    for f in cuda_build.COUNTED:
        f.launches = 0
    tuner = _tuner(torch, pt)
    tuner_launches = {f.__name__: f.launches for f in cuda_build.COUNTED if f.launches}
    emit("serving_tier_tuner_launches", launches=tuner_launches)
    missing = [n for n in ("flash_attn_fwd", "flash_attn_fwd_q64", "fused_conv1x1_bn_fwd")
               if not tuner_launches.get(n)]
    if missing:
        raise SystemExit(f"the tuner's search launched no {missing}")
    torch.cuda.empty_cache()
    fuse = _fuse_search(torch, pt, workdir)
    torch.cuda.empty_cache()
    served = _serving_pool(torch, pt, workdir)
    probes = _port_faults_on_card(torch)
    torch.cuda.empty_cache()
    emit("serving_tier", seconds=time.perf_counter() - t0)
    return dict(tiles=tiles, tuner=tuner, tuner_launches=tuner_launches, fuse=fuse,
                pool=served, probes=probes)


# ---------------------------------------------------------------------------------------
# Phase 22: object detection
# ---------------------------------------------------------------------------------------

# YOLOv3 at PaddleDetection's yolov3_darknet.yml COCO sizes: DarkNet-53 (the JAX
# model's defaults: scale 1.0, stage blocks 1-2-8-8-4), 80 classes, 608 x 608,
# batch 8, up to 50 gt boxes an image; Adam through the captured step
YOLO_SIZE, YOLO_BATCH, YOLO_GT, YOLO_CLASSES, YOLO_LR = 608, 8, 50, 80, 1e-3
YOLO_STEPS = 5
# ~141 GFLOP a forward image at 608 (the YOLOv3 paper's 140.69 Bn); a training
# step is about three forwards: 3 * 8 * 141e9 = 3.4 TFLOP, in f32 (TF32 off)
YOLO_FWD_FLOP = 141e9
YOLO_SERVE_WARM = {1: 10, 8: 4}       # warm requests timed at each batch
# the card against the CPU port, the same weights and inputs. Detections:
# rows are compared where their score stands apart from both neighbours by
# more than DET_SCORE_GAP in the CPU run (an order that rounding cannot swap):
# the label equal, the score within DET_SCORE_GAP and the box within
# DET_BOX_TOL. The heads differ by f32 sums in another order (cuDNN against
# the CPU's convolutions, through 75 of them at 608) and the decode's exp and
# sigmoid by an ulp: ~1e-5 of a score of ~0.2-0.5 and ~1e-4 of a box side.
DET_SCORE_GAP = 1e-4
DET_BOX_TOL = dict(rtol=1e-3, atol=0.1)
# the three smaller detectors, card against the CPU port from one state: step
# 1 within 1e-4 (cuDNN's and the CPU's f32 sums; their batch norms' E[x^2] -
# E[x]^2 cancel), steps 2-3 within 2e-3 (the tests' port-against-JAX limit:
# Adam's first steps turn gradient rounding into update differences)
DET_STEP1_RTOL, DET_LATER_RTOL = 1e-4, 2e-3
# the per-op cases on the card against the CPU port (detection_cases.py's
# tolerance tags): exact stays exact; BOX 1e-5 (the card's expf / logf /
# sigmoid round within 2 ulps where the CPU's are correctly rounded, and a
# box corner subtracts); SUM 1e-4 (cuDNN's and cuBLAS's sum orders); FOCAL 1e-5
DET_CARD_TOL = {"exact": dict(rtol=0, atol=0), "box": dict(rtol=1e-5, atol=1e-5),
                "sum": dict(rtol=1e-4, atol=1e-4), "focal": dict(rtol=1e-5, atol=1e-5)}


def _graph_nodes(torch, fn):
    """(nodes, kernel nodes) of a CUDA graph that captures one call of
    ``fn`` with autograd off."""
    with torch.no_grad():
        nodes = _graph_dot_nodes(torch, fn)
    return len(nodes), sum("KERNEL" in node for node in nodes)


class _OpSpy:
    """Counts the calls of the detection and vision lowerings on the card
    (shape inference's meta calls aside) by path, and, while ``count_launches``
    is on, captures one more call of each (op type, path) into a CUDA graph
    of its own to count its launches at that path's shapes."""

    def __init__(self, torch):
        from paddle_tpu_torch.core import registry as treg
        from paddle_tpu_torch.tools.detection_cases import DETECTION_TYPES, NN_TYPES
        self.torch, self.treg = torch, treg
        self.path, self.count_launches = None, False
        self.calls, self.launches = {}, {}
        self._saved = {}
        self.types = sorted(DETECTION_TYPES | NN_TYPES)
        for t in self.types:
            d = treg.get(t)
            self._saved[t] = d.lower
            d.lower = self._wrap(t, d.lower)

    def _wrap(self, t, lower):
        def spy(ctx, ins):
            out = lower(ctx, ins)
            if ctx.device.type == "cuda" and self.path is not None:
                key = (t, self.path)
                self.calls[key] = self.calls.get(key, 0) + 1
                if self.count_launches and key not in self.launches \
                        and not self.torch.cuda.is_current_stream_capturing():
                    self.launches[key] = _graph_nodes(self.torch, lambda: lower(ctx, ins))
            return out
        return spy

    def close(self):
        for t, lower in self._saved.items():
            self.treg.get(t).lower = lower

    def table(self):
        by_type = {}
        for (t, path), n in sorted(self.calls.items()):
            row = by_type.setdefault(t, {"calls": 0, "paths": {}})
            row["calls"] += n
            nodes = self.launches.get((t, path))
            row["paths"][path] = {"calls": n, "graph_nodes_a_call": nodes and nodes[0],
                                  "kernel_launches_a_call": nodes and nodes[1]}
        return by_type


def yolo_feed(rng, batch, size=YOLO_SIZE, n_gt=YOLO_GT, classes=YOLO_CLASSES):
    """Seeded images in [0, 1) and gt boxes (cx, cy, w, h, normalized).
    Image i has n_gt - 4i real rows, the rest padded (w * h = 0); real rows
    come in pairs that share a box centre (so a cell and an anchor slot at
    every head) with sides 2% apart, each pair in a stride-32 cell of its
    own (no three gts ever share a cell)."""
    img = rng.uniform(0, 1, (batch, 3, size, size)).astype(np.float32)
    grid = size // 32
    gt = np.zeros((batch, n_gt, 4), np.float32)
    for i in range(batch):
        n_real = max(2, n_gt - 4 * i)
        cells = rng.choice(grid * grid, size=(n_real + 1) // 2, replace=False)
        for k in range(n_real):
            c = cells[k // 2]
            if k % 2 == 0:
                cx = (c % grid + rng.uniform(0.2, 0.8)) / grid
                cy = (c // grid + rng.uniform(0.2, 0.8)) / grid
                w, h = rng.uniform(0.02, 0.5, 2)
                gt[i, k] = [cx, cy, w, h]
            else:
                gt[i, k] = gt[i, k - 1] * np.array([1, 1, 1.02, 1.02], np.float32)
    labels = rng.randint(0, classes, (batch, n_gt)).astype(np.int32)
    return {"img": img, "gt_box": gt, "gt_label": labels}


def _yolo_programs(pt, size=YOLO_SIZE):
    from paddle_tpu_torch.models import yolov3
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = SEED
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.data("img", [3, size, size], "float32")
        gt_box = pt.data("gt_box", [YOLO_GT, 4], "float32")
        gt_label = pt.data("gt_label", [YOLO_GT], "int32")
        loss = yolov3.yolov3(img, gt_box, gt_label, num_classes=YOLO_CLASSES)
        pt.optimizer.Adam(YOLO_LR).minimize(loss)
    infer, infer_start = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(infer, infer_start):
        img = pt.data("img", [3, size, size], "float32")
        img_size = pt.data("img_size", [2], "int32")
        dets, nums = yolov3.yolov3_infer(img, img_size, num_classes=YOLO_CLASSES)
    return main, startup, loss, infer, dets, nums


def _last_nms(program):
    return [op for op in program.global_block().ops if op.type == "multiclass_nms"][-1]


def _dets_agree(card, cpu, nums_card, nums_cpu):
    """The gap rule (DET_SCORE_GAP, DET_BOX_TOL) over every image's rows:
    (rows held, rows, the first disagreement or None)."""
    held, first = 0, None
    for n in range(cpu.shape[0]):
        if int(nums_card[n]) != int(nums_cpu[n]) and first is None:
            first = dict(image=n, nums=[int(nums_card[n]), int(nums_cpu[n])])
        k = int(nums_cpu[n])
        s = cpu[n, :k, 1]
        gap = np.minimum(np.abs(np.diff(s, prepend=np.inf)), np.abs(np.diff(s, append=-np.inf)))
        for r in np.flatnonzero(gap > DET_SCORE_GAP):
            held += 1
            a, b = card[n, r], cpu[n, r]
            ok = (a[0] == b[0] and abs(a[1] - b[1]) <= DET_SCORE_GAP
                  and np.allclose(a[2:], b[2:], **DET_BOX_TOL))
            if not ok and first is None:
                first = dict(image=n, row=int(r), card=a.tolist(), cpu=b.tolist())
    return held, int(sum(int(x) for x in nums_cpu)), first


def _nms_alone(torch, op, boxes, scores, runs=10):
    """The serving program's multiclass_nms lowering alone on its own inputs:
    the device ms of one replay of its CUDA graph (CUDA events, median of
    ``runs``), the graph's nodes and kernel launches, and its outputs."""
    from paddle_tpu_torch.core import registry as treg
    ctx = treg.LowerCtx(dict(op.attrs), device=boxes.device)
    fn = lambda: treg.get("multiclass_nms").lower(ctx, {"BBoxes": [boxes], "Scores": [scores]})
    eager = fn()
    nodes, kernels = _graph_nodes(torch, fn)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn()
    times = []
    for _ in range(runs):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        t0.record()
        graph.replay()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    same = all(torch.equal(outs[k][0], eager[k][0]) for k in ("Out", "NmsRoisNum"))
    del graph
    return dict(ms=statistics.median(times), graph_nodes=nodes, kernel_launches=kernels,
                replay_equals_eager=same, K=min(int(op.attrs["nms_top_k"]), scores.shape[2]),
                classes=int(scores.shape[1]))


def _yolo_train(torch, pt, spy):
    """A: YOLOv3 at 608 x 608, batch 8, Adam through the captured step against
    the same steps run eagerly, bit for bit; step ms, busy ms, idle share,
    launches a step, the graph's pool and the per-op launches."""
    from paddle_tpu_torch.core import cuda_build
    from paddle_tpu_torch.core.executor import capture_refusal
    main, startup, loss, infer, dets, nums = _yolo_programs(pt)
    raw = yolo_feed(np.random.RandomState(SEED), YOLO_BATCH)
    feed = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    init = _startup_state(pt, main, startup)
    refusal = capture_refusal(main)
    if refusal is not None:
        raise SystemExit(f"detection A: the YOLOv3 step is not captured: {refusal}")
    runs, launches = {}, {}
    for path in ("graph", "eager"):
        exe = pt.Executor()
        exe._use_graphs = path == "graph"
        spy.path, spy.count_launches = f"yolov3_training_{path}", path == "eager"
        for fn in cuda_build.COUNTED:
            fn.launches = 0
        outs, state, scope = _steps(pt, exe, main, feed, [loss], init, YOLO_STEPS)
        torch.cuda.synchronize()
        launches[path] = {fn.__name__: fn.launches for fn in cuda_build.COUNTED if fn.launches}
        if path == "graph":
            captured = [s for s in exe._cache.values() if s.graph is not None]
            if not captured or any(s.refusal is not None for s in exe._cache.values()):
                raise SystemExit("detection A: no CUDA graph was captured for the YOLOv3 step")
        runs[path] = ([o[0].clone() for o in outs], {n: t.clone() for n, t in state.items()})
        exe.close()
        del exe, outs, state, scope
        torch.cuda.empty_cache()
    spy.path, spy.count_launches = None, False
    losses = [float(t.reshape(-1)[0]) for t in runs["graph"][0]]
    loss_equal = [torch.equal(a, b) for a, b in zip(runs["graph"][0], runs["eager"][0])]
    differs = _state_equal(torch, runs["graph"][1], runs["eager"][1])
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"detection A: YOLOv3 losses not finite and falling: {losses}")
    if not all(loss_equal) or differs:
        raise SystemExit(f"detection A: the captured YOLOv3 steps part from the eager ones: "
                         f"losses {loss_equal}, state {differs[:8]}")
    timed = _timed_path(torch, pt, main, feed, loss, init, graphs_on=True, free_dead=True)
    bound_ms = 3 * YOLO_BATCH * YOLO_FWD_FLOP / PEAK_FLOPS["float32"] * 1e3
    r = dict(model="yolov3 darknet53", size=YOLO_SIZE, batch=YOLO_BATCH, gt_rows=YOLO_GT,
             classes=YOLO_CLASSES, steps=YOLO_STEPS, losses=losses,
             losses_eager=[float(t.reshape(-1)[0]) for t in runs["eager"][0]],
             graph_bit_equal_to_eager=True, state_tensors=len(init),
             multi_tensor_update_launches=launches,
             step_ms=timed["step_ms_median_warm"], step_ms_all=timed["step_ms"],
             device_busy_ms=timed["device_busy_ms"],
             idle_share=timed["idle_share_unprofiled"],
             idle_share_profiled=timed["idle_share_profiled"],
             launches_per_step=timed["device_activities_per_step"],
             by_kind=timed["by_kind"], graph_pool_gb=timed["graph_pool_gb"],
             peak_gb=timed["peak_gb"], f32_bound_ms=bound_ms,
             step_flop=3 * YOLO_BATCH * YOLO_FWD_FLOP)
    emit("detection_yolov3_training", **r)
    return r, runs["graph"][1], (infer, dets, nums)


def _yolo_serve(torch, pt, workdir, state, infer, dets, nums):
    """B: ``yolov3_infer`` with the trained weights, saved and served by the
    port's Predictor at batch 1 and 8 (graph replays, no capture in traffic),
    the NMS sweep's device ms apart, and batch 1 against the CPU Predictor."""
    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.tools.train_profile import traced
    from torch.profiler import ProfilerActivity
    model_dir = os.path.join(workdir, "yolov3")
    scope = pt.Scope()
    for n, t in state.items():
        scope.set_var(n, t)
    with pt.scope_guard(scope):
        pt.io.save_inference_model(model_dir, ["img", "img_size"], [dets, nums], pt.Executor(),
                                   main_program=infer)
    rng = np.random.RandomState(SEED + 22)
    pred = Predictor(model_dir)
    rows = []
    for batch, warm in YOLO_SERVE_WARM.items():
        req = {"img": rng.uniform(0, 1, (batch, 3, YOLO_SIZE, YOLO_SIZE)).astype(np.float32),
               "img_size": np.full((batch, 2), YOLO_SIZE, np.int32)}
        t0 = time.perf_counter()
        cold = pred.run(req)
        cold_ms = (time.perf_counter() - t0) * 1e3
        misses = pred._cache_counts["miss"]
        lat = []
        for _ in range(warm):
            t0 = time.perf_counter()
            out = pred.run(req)
            lat.append((time.perf_counter() - t0) * 1e3)
        if pred._cache_counts["miss"] != misses:
            raise SystemExit("detection B: a warm request captured a graph")
        if not all(np.array_equal(a, b) for a, b in zip(out, cold)):
            raise SystemExit("detection B: a replay parts from the first request's outputs")
        torch.cuda.synchronize()
        with traced([ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                pred.run(req)
            torch.cuda.synchronize()
        busy = _device_busy_ms(prof) / 3
        # the NMS inputs of this request, from the eager program on the card
        op = _last_nms(infer)
        exe = pt.Executor()
        exe._use_graphs = False
        with pt.scope_guard(scope):
            b, s = exe.run(infer, feed=req, fetch_list=[op.inputs["BBoxes"][0],
                                                        op.inputs["Scores"][0]],
                           return_numpy=False)
        nms = _nms_alone(torch, op, b, s)
        if not nms["replay_equals_eager"]:
            raise SystemExit("detection B: the NMS graph's replay parts from its eager run")
        dets_, nums_ = out
        if not (np.isfinite(dets_).all() and dets_.shape == (batch, 100, 6)):
            raise SystemExit(f"detection B: served detections {dets_.shape} not finite")
        row = dict(batch=batch, cold_ms=cold_ms, p50_ms=statistics.median(lat), ms=lat,
                   device_busy_ms=busy, nms_device_ms=nms["ms"],
                   network_device_ms=busy - nms["ms"], nms=nms,
                   kept=[int(x) for x in nums_], graphs=len(pred._compiled))
        if batch == 1:
            cpu_out = Predictor(model_dir, device="cpu").run(req)
            held, total, first = _dets_agree(dets_, cpu_out[0], nums_, cpu_out[1])
            row["against_cpu"] = dict(rows_held=held, rows=total, first_disagreement=first)
            if first is not None or held == 0:
                raise SystemExit(f"detection B: batch 1 parts from the CPU port: {first}")
        rows.append(row)
        emit("detection_yolov3_serving", **row)
        del b, s
    shutil.rmtree(model_dir, ignore_errors=True)
    return rows


def _small_detectors(pt):
    """(name, train build, infer build, feed): each detector at its JAX
    test's TINY size (tests/test_faster_rcnn.py:11, test_retinanet.py:56,
    test_mask_rcnn.py:89)."""
    from paddle_tpu_torch.models import faster_rcnn, mask_rcnn, retinanet
    A = dict(append_batch_size=False)
    frcnn = dict(scale=0.125, stage_blocks=(1, 1, 1), num_classes=5,
                 anchor_sizes=(32, 64), aspect_ratios=(1.0,), post_nms_top_n=16)
    retina = dict(scale=0.1, levels=2, num_classes=5, n_convs=1)
    mrcnn = dict(scale=0.1, levels=2, num_classes=4, post_nms_top_n=12,
                 roi_resolution=4, mask_resolution=4)
    rng = np.random.RandomState(SEED)
    boxes = np.zeros((2, 3, 4), np.float32)
    boxes[:, 0] = [8, 8, 28, 28]
    boxes[:, 1] = [36, 30, 60, 50]
    frcnn_feed = {"img": rng.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32),
                  "gt_box": boxes, "gt_label": rng.randint(1, 5, (2, 3)).astype(np.int32),
                  "im_info": np.tile(np.array([[64, 64, 1.0]], np.float32), (2, 1))}
    one = {"img": rng.uniform(0, 1, (1, 3, 64, 64)).astype(np.float32),
           "gt_box": np.array([[[8, 8, 40, 40], [30, 20, 62, 60]]], np.float32),
           "gt_label": np.array([[1, 3]], np.int32),
           "im_info": np.array([[64, 64, 1.0]], np.float32)}
    masks = np.zeros((1, 2, 32, 32), np.float32)
    masks[0, 0, 2:14, 2:14] = 1
    masks[0, 1, 18:28, 16:30] = 1
    mfeed = dict(one, gt_box=np.array([[[4, 4, 28, 28], [32, 36, 60, 58]]], np.float32),
                 gt_masks=masks)

    def data(n, g, with_masks=False):
        d = [pt.data("img", [n, 3, 64, 64], "float32", **A),
             pt.data("gt_box", [n, g, 4], "float32", **A),
             pt.data("gt_label", [n, g], "int32", **A)]
        if with_masks:
            d.append(pt.data("gt_masks", [n, g, 32, 32], "float32", **A))
        return d + [pt.data("im_info", [n, 3], "float32", **A)]

    def infer_data(n):
        return (pt.data("img", [n, 3, 64, 64], "float32", **A),
                pt.data("im_info", [n, 3], "float32", **A))

    return [
        ("faster_rcnn", lambda: faster_rcnn.faster_rcnn(*data(2, 3), batch_size=2, **frcnn)[0],
         lambda: list(faster_rcnn.faster_rcnn_infer(*infer_data(2), batch_size=2,
                                                    keep_top_k=20, **frcnn)),
         frcnn_feed),
        ("retinanet", lambda: retinanet.retinanet(*data(1, 2), batch_size=1, **retina)[0],
         lambda: [retinanet.retinanet_infer(*infer_data(1), batch_size=1, keep_top_k=20,
                                            **retina)],
         one),
        ("mask_rcnn", lambda: mask_rcnn.mask_rcnn(*data(1, 2, True), batch_size=1, **mrcnn)[0],
         lambda: list(mask_rcnn.mask_rcnn_infer(*infer_data(1), batch_size=1, keep_top_k=10,
                                                **mrcnn)),
         mfeed)]


def _small_detector(torch, pt, workdir, spy, name, train_build, infer_build, raw):
    """C: 3 captured Adam steps on the card against the CPU port's 3 from the
    same state, then one served batch against the CPU Predictor."""
    from paddle_tpu_torch.core.executor import capture_refusal
    from paddle_tpu_torch.inference import Predictor
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = SEED
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss = train_build()
        pt.optimizer.Adam(1e-3).minimize(loss)
    infer, infer_start = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(infer, infer_start):
        fetch = infer_build()
    init = _startup_state(pt, main, startup)
    if capture_refusal(main) is not None:
        raise SystemExit(f"detection C: {name}'s step is not captured: {capture_refusal(main)}")
    feed = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    spy.path, spy.count_launches = f"{name}_training_eager", True
    exe = pt.Executor()
    exe._use_graphs = False
    _steps(pt, exe, main, feed, [loss], init, 1)
    spy.path, spy.count_launches = f"{name}_training", False
    from paddle_tpu_torch.core import cuda_build
    for fn in cuda_build.COUNTED:
        fn.launches = 0
    exe = pt.Executor()
    outs, _, _ = _steps(pt, exe, main, feed, [loss], init, 3)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in cuda_build.COUNTED if fn.launches}
    captured = sum(s.graph is not None for s in exe._cache.values())
    if not captured:
        raise SystemExit(f"detection C: no CUDA graph was captured for {name}'s step")
    exe.close()
    card = [float(o[0].reshape(-1)[0]) for o in outs]
    cpu_scope = pt.Scope()
    for n, t in init.items():
        cpu_scope.set_var(n, t.cpu().clone())
    with pt.scope_guard(cpu_scope):
        cexe = pt.Executor(pt.CPUPlace())
        cpu = [float(np.asarray(cexe.run(main, feed=raw, fetch_list=[loss])[0]).reshape(()))
               for _ in range(3)]
    rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
    if not (np.isfinite(card).all() and rel[0] <= DET_STEP1_RTOL
            and max(rel[1:]) <= DET_LATER_RTOL):
        raise SystemExit(f"detection C: {name}'s card losses {card} part from the CPU "
                         f"port's {cpu}")
    # one served batch from the startup state, card and CPU Predictors
    model_dir = os.path.join(workdir, name)
    scope = pt.Scope()
    for n, t in init.items():
        scope.set_var(n, t)
    with pt.scope_guard(scope):
        pt.io.save_inference_model(model_dir, ["img", "im_info"], fetch, pt.Executor(),
                                   main_program=infer)
    req = {"img": raw["img"], "im_info": raw["im_info"]}
    spy.path = f"{name}_serving"
    pred = Predictor(model_dir)
    got = pred.run(req)
    again = pred.run(req)
    spy.path = None
    want = Predictor(model_dir, device="cpu").run(req)
    if not all(np.array_equal(a, b) for a, b in zip(got, again)):
        raise SystemExit(f"detection C: {name}'s replay parts from its first request")
    nums_card = got[1] if len(got) > 1 else (got[0][..., 0] >= 0).sum(-1)
    nums_cpu = want[1] if len(want) > 1 else (want[0][..., 0] >= 0).sum(-1)
    held, total, first = _dets_agree(got[0], want[0], nums_card, nums_cpu)
    if first is not None:
        raise SystemExit(f"detection C: {name}'s served detections part from the CPU "
                         f"port's: {first}")
    r = dict(model=name, losses=card, losses_cpu=cpu, loss_rel_gaps=rel, graphs=captured,
             multi_tensor_update_launches=launches,
             served_rows_held=held, served_rows=total,
             mask_max_abs_gap=(float(np.abs(got[2] - want[2]).max()) if name == "mask_rcnn"
                               else None))
    if name == "mask_rcnn" and r["mask_max_abs_gap"] > 1e-3:
        raise SystemExit(f"detection C: mask_rcnn's masks part from the CPU port's by "
                         f"{r['mask_max_abs_gap']}")
    shutil.rmtree(model_dir, ignore_errors=True)
    emit("detection_small", **r)
    return r


def _detection_cases_on_card(torch):
    """D: every case of tools/detection_cases.py on the card against the CPU
    port (DET_CARD_TOL by the case's tag), each card call also captured as a
    CUDA graph (no host sync) with its launches counted; then roi_align's
    and yolov3_loss's gradients on the card against the CPU."""
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.tools import detection_cases as dc
    tags = {id(dc.EXACT): "exact", id(dc.BOX): "box", id(dc.SUM): "sum", id(dc.FOCAL): "focal"}
    rows = []
    for case, (op_type, ins, attrs, tol) in sorted(dc.CASES.items()):
        tol = DET_CARD_TOL[tags[id(tol)]]
        outs = {}
        for dev in ("cpu", "cuda"):
            ctx = treg.LowerCtx(dict(attrs), device=dev)
            tins = {s: [torch.from_numpy(np.array(a)).to(dev) for a in v] for s, v in ins.items()}
            outs[dev] = treg.get(op_type).lower(ctx, tins)
        nodes = _graph_nodes(torch, lambda: treg.get(op_type).lower(ctx, tins))
        err = 0.0
        for slot, vals in outs["cpu"].items():
            for a, b in zip(vals, outs["cuda"][slot]):
                a, b = a.detach().numpy(), b.detach().cpu().numpy()
                if a.dtype.kind in "iub" or tol["atol"] == 0:
                    ok = np.array_equal(a, b)
                else:
                    ok = np.allclose(b, a, **tol)
                    err = max(err, float(np.abs(a.astype(np.float64) - b).max()) if a.size else 0)
                if not ok:
                    raise SystemExit(f"detection D: {case} {slot} parts from the CPU port")
        rows.append(dict(case=case, op=op_type, tol=tags[id(dc.CASES[case][3])],
                         max_abs_err=err, graph_nodes=nodes[0], kernel_launches=nodes[1]))
    grads = []
    for case in ("roi_align", "roi_align-ratio3", "yolov3_loss", "interpolate-bilinear-1-3x"):
        op_type, ins, attrs, _ = dc.CASES[case]
        slot = "Loss" if op_type == "yolov3_loss" else "Out"
        g = {}
        for dev in ("cpu", "cuda"):
            x = torch.from_numpy(np.array(ins["X"][0])).to(dev).requires_grad_()
            tins = {s: [x] if s == "X" else [torch.from_numpy(np.array(a)).to(dev) for a in v]
                    for s, v in ins.items()}
            out = treg.get(op_type).lower(treg.LowerCtx(dict(attrs), device=dev), tins)[slot][0]
            cot = torch.from_numpy(np.random.RandomState(7).randn(*out.shape)
                                   .astype(np.float32)).to(dev)
            g[dev] = torch.autograd.grad(out, x, cot)[0].cpu().numpy()
        err = float(np.abs(g["cpu"] - g["cuda"]).max())
        if not np.allclose(g["cuda"], g["cpu"], **DET_CARD_TOL["sum"]):
            raise SystemExit(f"detection D: {case}'s gradient parts from the CPU port's by {err}")
        grads.append(dict(case=case, max_abs_err=err))
    emit("detection_cases_on_card", cases=len(rows), op_types=sorted({r["op"] for r in rows}),
         rows=rows, grads=grads)
    return rows, grads


def phase_detection(torch, workdir):
    """Phase 22: YOLOv3 trained (A) and served (B) at 608 x 608, the other
    three detectors trained and served (C), the per-op cases on the card (D),
    every detection op type launched at least once."""
    import paddle_tpu_torch as pt
    t0 = time.perf_counter()
    spy = _OpSpy(torch)
    try:
        train, state, (infer, dets, nums) = _yolo_train(torch, pt, spy)
        torch.cuda.empty_cache()
        spy.path = "yolov3_serving"
        serving = _yolo_serve(torch, pt, workdir, state, infer, dets, nums)
        del state
        torch.cuda.empty_cache()
        small = [_small_detector(torch, pt, workdir, spy, *d) for d in _small_detectors(pt)]
        spy.path = "cases"
        cases, grads = _detection_cases_on_card(torch)
        spy.path = None
    finally:
        spy.close()
    table = spy.table()
    missing = [t for t in spy.types if t not in table]
    emit("detection_op_types", ran=table, missing=missing)
    if missing:
        raise SystemExit(f"detection: op types never launched on the card: {missing}")
    torch.cuda.empty_cache()
    emit("detection", seconds=time.perf_counter() - t0)
    return dict(train=train, serving=serving, small=small, cases=cases, grads=grads,
                op_types=table, seconds=time.perf_counter() - t0)


# ------------------------------------------------------------------------ phase 23

#: the MT-book While of tests/test_control_flow_dsl.py::test_while_trains_params_in_body
#: at width 512, batch 128, max_iters 32; the condition turns false after CF_LIMIT
#: runs, so the last 8 runs of the masked loop are inactive
CF_WIDTH, CF_BATCH, CF_MAX_ITERS, CF_LIMIT, CF_STEPS = 512, 128, 32, 24, 5
#: the test's Adam 0.05 is for its width 8; at width 512 it diverges (measured on
#: one H100: the loss rose 0.473 to 0.836 in 5 steps)
CF_LR = 1e-3
#: step 1 of the While program on the card against the CPU port at batch 2, and
#: the unbounded While's outputs: tests/test_torch_control_flow.py's tolerance
#: (f32 sums and tanh in other orders, a few ulps through 24 runs of the body)
CF_RTOL, CF_ATOL = 1e-5, 1e-6
#: a vision op on the card against the CPU port at the models' shapes, forward and
#: gradient: |card - cpu| <= VISION_CARD_REL * max|cpu|. cuDNN and the CPU sum a
#: convolution's up to 1,728 f32 products (and a norm's reductions of up to
#: 100,352 values) in other orders, and cuDNN may take a Winograd or FFT route for
#: a 3-D kernel: about 1e-5 of the largest output; 1e-4 bounds it.
VISION_CARD_REL = 1e-4
SLIM_RATIO, SLIM_STEPS = 0.5, 5
#: examples/prune_finetune.py's constants: 512 synthetic CIFAR-shaped images,
#: batch 64, 4 epochs, prune half, 4 finetune epochs
PRUNE_EXAMPLE_N, PRUNE_EXAMPLE_BS, PRUNE_EXAMPLE_EPOCHS = 512, 64, 4


def _while_program(pt, width, max_iters, train=True):
    """The MT-book shape: an fc with a tanh in a While body, trained with Adam
    (``train``); else the body is tanh(acc / 2 + x) and nothing trains."""
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 9
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.data("x", [width], "float32")
        target = pt.data("target", [width], "float32")
        h = L.fill_constant_batch_size_like(x, [-1, width], "float32", 0.0)
        i = L.fill_constant([1], "float32", 0)
        limit = L.fill_constant([1], "float32", CF_LIMIT)
        cond = L.less_than(i, limit)
        w = L.While(cond, max_iters=max_iters)
        with w.block():
            if train:
                step = L.fc(L.elementwise_add(h, x), width, act="tanh",
                            param_attr=pt.ParamAttr(name="loop_w"))
            else:
                step = L.tanh(L.elementwise_add(L.scale(h, 0.5), x))
            L.assign(step, h)
            L.increment(i, in_place=True)
            L.less_than(i, limit, cond=cond)
        loss = L.reduce_mean(L.square(L.elementwise_sub(h, target)))
        if train:
            pt.optimizer.Adam(CF_LR).minimize(loss)
    return main, startup, loss, h, i


def _cf_feed(torch, batch, width, device, seed=1):
    rng = np.random.RandomState(seed)
    return {"x": torch.from_numpy(rng.randn(batch, width).astype(np.float32)).to(device),
            "target": torch.from_numpy((rng.randn(batch, width) * 0.1).astype(np.float32))
            .to(device)}


def _graph_vs_eager(torch, pt, main, feeds, fetch, init, launches=None):
    """The graph executor against the eager one over ``feeds`` (a step each)
    from ``init``: (graph fetches, eager fetches, state names that differ,
    graph step ms after the capture, whether a graph was captured). Given a
    dict, ``launches`` gets each path's counts of the hand-written kernels
    (``cuda_build.COUNTED``, set to 0 before the path) under "graph" and
    "eager"."""
    from paddle_tpu_torch.core import cuda_build
    runs = {}
    for graphs_on in (True, False):
        for fn in cuda_build.COUNTED:
            fn.launches = 0
        exe = pt.Executor()
        exe._use_graphs = graphs_on
        scope = pt.Scope()
        for n, t in init.items():
            scope.set_var(n, t.clone())
        main._rng_run_counter = 0
        outs, times = [], []
        with pt.scope_guard(scope):
            for feed in feeds:
                t0 = time.perf_counter()
                outs.append([o.clone() for o in exe.run(main, feed=feed, fetch_list=fetch,
                                                        return_numpy=False)])
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        captured = any(s.graph is not None for s in exe._cache.values())
        runs[graphs_on] = (outs, {n: scope.find_var(n).clone() for n in init}, times, captured)
        if launches is not None:
            launches["graph" if graphs_on else "eager"] = {
                fn.__name__: fn.launches for fn in cuda_build.COUNTED if fn.launches}
        exe.close()
    (g, gs, gt, cap), (e, es, et, _) = runs[True], runs[False]
    return g, e, _state_equal(torch, gs, es), dict(graph=gt, eager=et), cap


def _cf_while_training(torch, pt):
    """A: the bounded While trained through the captured step, graph against
    eager bit for bit; step 1 against the CPU port at batch 2."""
    from paddle_tpu_torch.core.executor import capture_refusal
    main, startup, loss, _, _ = _while_program(pt, CF_WIDTH, CF_MAX_ITERS)
    if capture_refusal(main) is not None:
        raise SystemExit(f"control flow A: the bounded While is refused: {capture_refusal(main)}")
    init = _startup_state(pt, main, startup)
    feed = _cf_feed(torch, CF_BATCH, CF_WIDTH, "cuda")
    g, e, differs, ms, captured = _graph_vs_eager(torch, pt, main, [feed] * CF_STEPS,
                                                  [loss], init)
    losses = [float(o[0].reshape(())) for o in g]
    bit_equal = all(torch.equal(a[0], b[0]) for a, b in zip(g, e)) and not differs
    feed2 = _cf_feed(torch, 2, CF_WIDTH, "cpu")
    step1 = {}
    for dev in ("cpu", "cuda"):
        scope = pt.Scope()
        for n, t in init.items():
            scope.set_var(n, t.to(dev, copy=True))
        with pt.scope_guard(scope):
            step1[dev] = float(pt.Executor(pt.CPUPlace() if dev == "cpu" else None).run(
                main, feed={k: v.to(dev) for k, v in feed2.items()}, fetch_list=[loss])[0])
    r = dict(model=f"While(max_iters={CF_MAX_ITERS}) over fc({CF_WIDTH}, tanh), {CF_LIMIT} live "
                   f"runs, B{CF_BATCH}, Adam {CF_LR}", captured=captured, losses=losses,
             graph_eager_bit_equal=bit_equal, state_differs=differs[:8],
             step_ms_graph=statistics.median(ms["graph"][2:]),
             step_ms_eager=statistics.median(ms["eager"][1:]),
             step1_batch2={"card": step1["cuda"], "cpu_port": step1["cpu"],
                           "rel_gap": abs(step1["cuda"] - step1["cpu"]) / abs(step1["cpu"])})
    emit("control_flow_while_training", **r)
    if not (captured and bit_equal):
        raise SystemExit(f"control flow A: the captured While step parts from the eager one: {r}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise SystemExit(f"control flow A: the While program's loss does not fall: {losses}")
    if not np.isclose(step1["cuda"], step1["cpu"], rtol=CF_RTOL, atol=CF_ATOL):
        raise SystemExit(f"control flow A: step 1 parts from the CPU port: {r['step1_batch2']}")
    return r


def _cf_unbounded_while(torch, pt):
    """A: a While without max_iters: refused capture (the reason names
    ``while``), run eagerly, equal to the CPU port; its launches a run."""
    import warnings
    from paddle_tpu_torch.core.executor import capture_refusal
    from paddle_tpu_torch.tools.train_profile import profile_steps
    main, _, loss, h, i = _while_program(pt, CF_WIDTH, None, train=False)
    why = capture_refusal(main)
    print(f"control flow A: capture refused: {why}", flush=True)
    if why is None or "'while'" not in why:
        raise SystemExit(f"control flow A: the unbounded While's refusal does not name it: {why}")
    feed = _cf_feed(torch, CF_BATCH, CF_WIDTH, "cuda", seed=2)
    outs = {}
    exe = pt.Executor()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with pt.scope_guard(pt.Scope()):
            times = []
            for _ in range(4):
                t0 = time.perf_counter()
                outs["cuda"] = exe.run(main, feed=feed, fetch_list=[h, i, loss])
                times.append((time.perf_counter() - t0) * 1e3)
            prof = profile_steps(torch, exe, main, feed, [h, i, loss], PROFILED_STEPS)
    warned = any("'while' has no max_iters" in str(w.message) for w in caught)
    captured = any(s.graph is not None for s in exe._cache.values())
    exe.close()
    with pt.scope_guard(pt.Scope()):
        outs["cpu"] = pt.Executor(pt.CPUPlace()).run(
            main, feed={k: v.cpu() for k, v in feed.items()}, fetch_list=[h, i, loss])
    err = float(np.abs(outs["cuda"][0] - outs["cpu"][0]).max())
    r = dict(refusal=why, warned=warned, captured=captured, iterations=float(outs["cuda"][1][0]),
             run_ms=statistics.median(times[1:]),
             device_activities_per_run=prof["device_activities_per_step"],
             device_busy_ms=prof["device_busy_ms"], idle_share=prof["device_idle_share"],
             max_abs_err_vs_cpu_port=err)
    emit("control_flow_unbounded_while", **r)
    if captured or not warned or outs["cuda"][1][0] != CF_LIMIT:
        raise SystemExit(f"control flow A: the unbounded While did not run eagerly: {r}")
    if not np.allclose(outs["cuda"][0], outs["cpu"][0], rtol=CF_RTOL, atol=CF_ATOL):
        raise SystemExit(f"control flow A: the unbounded While parts from the CPU port by {err}")
    return r


def _cf_ifelse_switch(torch, pt):
    """A: IfElse over rows (true in half, false in the other half) and a
    Switch on a fed value, each step a different case, trained captured,
    graph against eager bit for bit."""
    from paddle_tpu_torch.core.executor import capture_refusal
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 3
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.data("x", [CF_WIDTH], "float32")
        m = pt.data("m", [1], "float32")
        s = pt.data("s", [1], "float32")
        ie = L.IfElse(L.cast(m, "bool"))
        with ie.true_block():
            ie.output(L.fc(ie.input(x), CF_WIDTH, act="relu", param_attr=pt.ParamAttr(name="t_w")))
        with ie.false_block():
            ie.output(L.fc(ie.input(x), CF_WIDTH, act="tanh", param_attr=pt.ParamAttr(name="f_w")))
        out, = ie()
        sv = L.reshape(L.reduce_mean(s), [1])
        scale = L.fill_constant([1], "float32", 1.0)
        c1 = L.less_than(sv, L.fill_constant([1], "float32", 5.0))
        c2 = L.less_than(sv, L.fill_constant([1], "float32", 8.0))
        with L.Switch() as switch:
            for c, v in ((c1, 0.1), (c2, 0.2), (None, 0.3)):
                with (switch.case(c) if c is not None else switch.default()):
                    L.assign(L.fill_constant([1], "float32", v), scale)
        loss = L.elementwise_mul(L.reduce_mean(L.square(out)), scale)
        pt.optimizer.Adam(1e-3).minimize(loss)
    if capture_refusal(main) is not None:
        raise SystemExit(f"control flow A: IfElse / Switch refused: {capture_refusal(main)}")
    init = _startup_state(pt, main, startup)
    rng = np.random.RandomState(4)
    xv = torch.from_numpy(rng.randn(CF_BATCH, CF_WIDTH).astype(np.float32)).cuda()
    mv = torch.from_numpy((np.arange(CF_BATCH) % 2).astype(np.float32)[:, None]).cuda()
    feeds = [{"x": xv, "m": mv, "s": torch.full((1, 1), v).cuda()}
             for v in (3.0, 6.0, 9.0, 3.0, 9.0)]
    g, e, differs, ms, captured = _graph_vs_eager(torch, pt, main, feeds, [loss, scale, out],
                                                  init)
    scales = [float(o[1].reshape(-1)[0]) for o in g]
    bit_equal = all(torch.equal(a, b) for x, y in zip(g, e) for a, b in zip(x, y)) and not differs
    rows_true = int(mv.sum())
    r = dict(captured=captured, scales=scales, graph_eager_bit_equal=bit_equal,
             rows_true=rows_true, rows_false=CF_BATCH - rows_true,
             step_ms_graph=statistics.median(ms["graph"][2:]),
             losses=[float(o[0].reshape(())) for o in g])
    emit("control_flow_ifelse_switch", **r)
    if not (captured and bit_equal and np.allclose(scales, [0.1, 0.2, 0.3, 0.1, 0.3])):
        raise SystemExit(f"control flow A: IfElse / Switch through the graph: {r}")
    return r


def _cf_dynamic_rnn_lstm(torch, pt, chapters):
    """A: an LSTM written with DynamicRNN over the sentiment chapter's first
    feed at examples/understand_sentiment.py's widths, 5 captured steps."""
    from paddle_tpu_torch.tools import book
    L = pt.layers
    ch, feeds = next((c, f) for c, f, *_ in chapters if c.name == "understand_sentiment")
    emb_op = next(op for op in ch.main.global_block().ops if op.type.startswith("lookup_table"))
    vocab = ch.main.global_block().var(emb_op.inputs["W"][0]).shape[0]
    hid, max_len = book.SENT_HID, book.SENT_MAX_LEN
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 0
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        A = dict(append_batch_size=False)
        words = pt.data("words", [-1, max_len], "int64", **A)
        length = pt.data("length", [-1], "int64", **A)
        label = pt.data("label", [-1, 1], "int64", **A)
        e = L.embedding(words, [vocab, book.SENT_EMB])
        drnn = L.DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(e, lengths=length)
            h_prev = drnn.memory(shape=[hid], value=0.0)
            c_prev = drnn.memory(shape=[hid], value=0.0)
            gates = L.fc(L.concat([x_t, h_prev], axis=1), 4 * hid)
            gi, gf, go, gg = L.split(gates, 4, dim=1)
            c = L.elementwise_add(L.elementwise_mul(L.sigmoid(gf), c_prev),
                                  L.elementwise_mul(L.sigmoid(gi), L.tanh(gg)))
            hh = L.elementwise_mul(L.sigmoid(go), L.tanh(c))
            drnn.update_memory(h_prev, hh)
            drnn.update_memory(c_prev, c)
            drnn.output(hh)
        pooled = L.reduce_max(drnn(), dim=1)
        logits = L.fc(pooled, 2)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        pt.optimizer.Adam(book.SENT_LR).minimize(loss)
    init = _startup_state(pt, main, startup)
    feed = {k: torch.from_numpy(v).cuda() for k, v in feeds[0].items()}
    exe = pt.Executor()
    scope = pt.Scope()
    for n, t in init.items():
        scope.set_var(n, t.clone())
    times, losses = [], []
    with pt.scope_guard(scope):
        for _ in range(CF_STEPS):
            t0 = time.perf_counter()
            losses.append(float(exe.run(main, feed=feed, fetch_list=[loss])[0]))
            times.append((time.perf_counter() - t0) * 1e3)
    captured = any(s.graph is not None for s in exe._cache.values())
    exe.close()
    r = dict(model=f"DynamicRNN LSTM EMB {book.SENT_EMB} HID {hid} T {max_len} "
                   f"B {feed['words'].shape[0]}, vocab {vocab}",
             captured=captured, losses=losses, step_ms_graph=statistics.median(times[2:]))
    emit("control_flow_dynamic_rnn_lstm", **r)
    if not (captured and np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise SystemExit(f"control flow A: the DynamicRNN LSTM: {r}")
    return r


def _slim_resnet50(torch, pt, unpruned_step_ms):
    """B: ResNet-50 at phase 8's configuration, 50% of its conv weights pruned
    by magnitude, 5 captured steps; the pruned entries exactly 0 after each,
    K2's launches a step against the fuse pass's chains."""
    from paddle_tpu_torch.contrib import slim
    from paddle_tpu_torch.ops import conv_bn
    from paddle_tpu_torch.tools.train_profile import build_resnet50
    main, startup, loss, _, fused = build_resnet50()
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt.Executor().run(startup)
    convs = [n for n, v in main.global_block().vars.items()
             if getattr(v, "trainable", False) and len(v.shape) == 4]
    t0 = time.perf_counter()
    masks = slim.compute_magnitude_masks(scope, main, SLIM_RATIO,
                                         params=[f"^{re.escape(n)}$" for n in convs])
    slim.apply_pruning_masks(main, scope, masks)
    prune_s = time.perf_counter() - t0
    pruned = {n: torch.from_numpy(m == 0).cuda() for n, m in masks.items()}
    feed = _resnet_feed(torch, np.random.RandomState(SEED), RESNET_BATCH, "cuda")
    exe = pt.Executor()
    conv_bn.fused_conv1x1_bn_fwd.launches = 0
    times, losses, nonzero = [], [], []
    with pt.scope_guard(scope):
        for _ in range(SLIM_STEPS):
            t0 = time.perf_counter()
            losses.append(float(exe.run(main, feed=feed, fetch_list=[loss])[0]))
            times.append((time.perf_counter() - t0) * 1e3)
            nonzero.append(sum(int((scope.find_var(n)[p] != 0).sum()) for n, p in pruned.items()))
        dtypes = sorted({str(scope.find_var(n).dtype) for n in masks})
        sparsity = slim.sparsity(scope, masks)
    torch.cuda.synchronize()
    k2 = conv_bn.fused_conv1x1_bn_fwd.launches
    captured = any(s.graph is not None for s in exe._cache.values())
    exe.close()
    del scope, exe
    torch.cuda.empty_cache()
    r = dict(model=f"resnet50 NHWC space-to-depth stem bf16 B{RESNET_BATCH} 224x224, "
                   f"{len(masks)} conv filters pruned {SLIM_RATIO:.0%} by magnitude",
             pruned_weights=int(sum(int(p.sum()) for p in pruned.values())),
             prune_s=prune_s, sparsity=sparsity, param_dtypes=dtypes, captured=captured,
             losses=losses, nonzero_pruned_after_each_step=nonzero,
             k2_launches_per_step=k2 / SLIM_STEPS, chains_fused=fused,
             step_ms=times, step_ms_median_warm=statistics.median(times[2:]),
             unpruned_step_ms_phase8=unpruned_step_ms)
    emit("slim_resnet50", **r)
    if any(nonzero) or dtypes != ["torch.bfloat16"] or not captured:
        raise SystemExit(f"slim B: pruned entries regrew or the step was not captured: {r}")
    if k2 != fused * SLIM_STEPS:
        raise SystemExit(f"slim B: K2 launched {k2} times in {SLIM_STEPS} steps, the fuse pass "
                         f"fused {fused} chains")
    if not np.isfinite(losses).all():
        raise SystemExit(f"slim B: the pruned ResNet-50's loss is not finite: {losses}")
    return r


def _prune_finetune_example(torch, pt):
    """B: examples/prune_finetune.py's program on the card, to its bar: the
    eval loss rises after the prune, the finetune recovers it (the JAX
    suite's test_slim bar: under 0.7 of the pruned loss or 1.1 of the
    unpruned one) and the accuracy does not end below the pruned one's, and
    the pruned weights stay exactly 0. Whether the accuracy fell at the
    prune is printed."""
    from paddle_tpu_torch.contrib import slim
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 0
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.data("img", [3, 32, 32], "float32")
        label = pt.data("label", [1], "int64")
        h = L.pool2d(L.conv2d(img, 32, 3, padding=1, act="relu"), 2, "max", 2)
        h = L.pool2d(L.conv2d(h, 64, 3, padding=1, act="relu"), 2, "max", 2)
        logits = L.fc(h, 10)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        acc = L.accuracy(logits, label)
        pt.optimizer.Momentum(0.02, 0.9).minimize(loss)
    rng = np.random.RandomState(0)
    imgs = rng.rand(PRUNE_EXAMPLE_N, 3, 32, 32).astype(np.float32)
    labels = (imgs.mean(axis=(1, 2, 3)) * 10).astype(np.int64).clip(0, 9)[:, None]
    bs = PRUNE_EXAMPLE_BS
    batches = [{"img": torch.from_numpy(imgs[i:i + bs]).cuda(),
                "label": torch.from_numpy(labels[i:i + bs]).cuda()}
               for i in range(0, PRUNE_EXAMPLE_N - bs + 1, bs)]
    exe, scope = pt.Executor(), pt.Scope()

    def epoch(train):
        out = [exe.run(main, feed=b, fetch_list=[loss, acc], use_prune=not train)
               for b in batches]
        return (float(np.mean([o[0] for o in out])),
                float(np.mean([np.asarray(o[1]).reshape(-1)[0] for o in out])))

    t0 = time.perf_counter()
    with pt.scope_guard(scope):
        exe.run(startup)
        train = [epoch(True) for _ in range(PRUNE_EXAMPLE_EPOCHS)]
        before = epoch(False)
        masks = slim.compute_magnitude_masks(scope, main, ratio=0.5)
        slim.apply_pruning_masks(main, scope, masks)
        after = epoch(False)
        fine = [epoch(True) for _ in range(PRUNE_EXAMPLE_EPOCHS)]
        final = epoch(False)
        regrew = sum(int((scope.find_var(n)[torch.from_numpy(m == 0).cuda()] != 0).sum())
                     for n, m in masks.items())
        sparsity = slim.sparsity(scope, masks)
    exe.close()
    r = dict(train=train, before_prune=before, after_prune=after, finetune=fine, final=final,
             accuracy_fell_at_the_prune=after[1] < before[1], sparsity=sparsity, regrew=regrew,
             seconds=time.perf_counter() - t0)
    emit("prune_finetune_example", **r)
    bar = (after[0] > before[0] and final[1] >= after[1]
           and (final[0] < after[0] * 0.7 or final[0] < before[0] * 1.1))
    if regrew or abs(sparsity - 0.5) > 0.02 or not bar:
        raise SystemExit(f"slim B: examples/prune_finetune.py's bar is not met: {r}")
    return r


def _vision_cases_on_card(torch):
    """C: every case of tools/vision_cases.py at the models' shapes on the card
    against the CPU port, forward and generic grad (VISION_CARD_REL), each
    forward and gradient call captured in a CUDA graph with its launches
    counted."""
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.tools import vision_cases as vc

    def held(card, cpu, what):
        worst = 0.0
        for slot, vals in cpu.items():
            for a, b in zip(vals, card[slot]):
                if a is None:
                    continue
                a, b = a.detach().float().numpy(), b.detach().float().cpu().numpy()
                err = float(np.abs(a - b).max()) if a.size else 0.0
                if a.shape != b.shape or err > VISION_CARD_REL * max(float(np.abs(a).max()),
                                                                      1e-30):
                    raise SystemExit(f"vision C: {what} {slot} parts from the CPU port by {err}")
                worst = max(worst, err / max(float(np.abs(a).max()), 1e-30))
        return worst

    rows = []
    for name, c in sorted(vc.card_cases().items()):
        cpu = vc.forward(c, "cpu")
        tins = vc._tensors(c.ins, "cuda")
        ctx = treg.LowerCtx(dict(c.attrs), "cuda")
        card = treg.get(c.op).lower(ctx, tins)
        fwd = held(card, cpu, name)
        nodes = _graph_nodes(torch, lambda: treg.get(c.op).lower(ctx, tins))
        gins, gattrs = vc.grad_inputs(c, cpu)
        g_cpu = treg.get(c.op + "_grad").lower(treg.LowerCtx(gattrs, "cpu"), vc._tensors(gins, "cpu"))
        gtins = vc._tensors(gins, "cuda")
        gctx = treg.LowerCtx(gattrs, "cuda")
        g_card = treg.get(c.op + "_grad").lower(gctx, gtins)
        grd = held(g_card, g_cpu, name + " grad")
        gnodes = _graph_nodes(torch, lambda: treg.get(c.op + "_grad").lower(gctx, gtins))
        rows.append(dict(case=name, op=c.op, shape=list(np.shape(next(iter(c.ins.values()))[0])),
                         forward_rel_err=fwd, grad_rel_err=grd,
                         forward_kernel_launches=nodes[1], grad_kernel_launches=gnodes[1]))
        del cpu, tins, card, g_cpu, gtins, g_card
        torch.cuda.empty_cache()
    emit("vision_cases_on_card", cases=len(rows), rows=rows, rel_limit=VISION_CARD_REL)
    missing = vc.VISION_TYPES - {r["op"] for r in rows}
    if missing:
        raise SystemExit(f"vision C: op types without a case on the card: {sorted(missing)}")
    return rows


def _nchw_s2d_step1(torch, pt):
    """C: step 1 of the NCHW space-to-depth ResNet-50 (f32, Momentum) at batch
    2 on the card against the CPU port, from the card's startup state."""
    from paddle_tpu_torch.models import resnet
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = SEED
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.data("img", [3, 224, 224], "float32")
        label = pt.data("label", [1], "int64")
        loss, _, _ = resnet.resnet50(img, label, num_classes=1000, data_format="NCHW",
                                     conv1_space_to_depth=True)
        pt.optimizer.Momentum(0.1, 0.9).minimize(loss)
    init = _startup_state(pt, main, startup)
    rng = np.random.RandomState(SEED + 2)
    feed = {"img": torch.from_numpy(rng.randn(2, 3, 224, 224).astype(np.float32)),
            "label": torch.from_numpy(rng.randint(0, 1000, (2, 1)).astype(np.int64))}
    t0 = time.perf_counter()
    cpu = _resnet_step1(torch, pt, main, loss, {n: t.cpu() for n, t in init.items()}, feed, "cpu")
    cpu_s = time.perf_counter() - t0
    card = _resnet_step1(torch, pt, main, loss, init, {k: v.cuda() for k, v in feed.items()},
                         "cuda")
    g = dict(_resnet_gaps(card, cpu), cpu_seconds=cpu_s,
             space_to_depth_ops=[op.type for op in main.global_block().ops].count("space_to_depth"))
    emit("nchw_space_to_depth_resnet50_step1", **g, loss_rel_limit=RESNET_LOSS_REL,
         update_rel_l1_limit=RESNET_UPDATE_REL)
    if not (g["loss_rel_gap"] <= RESNET_LOSS_REL and g["update_rel_l1_gap"] <= RESNET_UPDATE_REL):
        raise SystemExit(f"vision C: the NCHW space-to-depth ResNet-50's step 1 parts from the "
                         f"CPU port: {g}")
    return g


def phase_slim_and_control_flow(torch, chapters, unpruned_step_ms=None):
    """Phase 23: control flow on the card (A), slim's pruned ResNet-50 through
    K2 and the prune-finetune example (B), the vision op cases and the NCHW
    space-to-depth ResNet-50 against the CPU port (C)."""
    import paddle_tpu_torch as pt
    t0 = time.perf_counter()
    a = dict(while_training=_cf_while_training(torch, pt),
             unbounded_while=_cf_unbounded_while(torch, pt),
             ifelse_switch=_cf_ifelse_switch(torch, pt),
             dynamic_rnn_lstm=_cf_dynamic_rnn_lstm(torch, pt, chapters))
    torch.cuda.empty_cache()
    b = dict(resnet50=_slim_resnet50(torch, pt, unpruned_step_ms),
             example=_prune_finetune_example(torch, pt))
    torch.cuda.empty_cache()
    c = dict(cases=_vision_cases_on_card(torch), nchw_s2d_step1=_nchw_s2d_step1(torch, pt))
    torch.cuda.empty_cache()
    emit("slim_and_control_flow", seconds=time.perf_counter() - t0)
    return dict(a=a, b=b, c=c, seconds=time.perf_counter() - t0)


# ------------------------------------------------------------------------ phase 24

#: crnn_ctc_model.py's training batch and the steps of A
OCR_BATCH, OCR_STEPS = 32, 5
#: serving batches and their warm requests
OCR_SERVE_WARM = {1: 20, 32: 10}
#: step 1 at batch 2 against the CPU port: the summed CTC loss within 1e-4
#: (cuDNN's and the CPU's convolution sums, 64 GRU steps each way, the 64-step
#: recursion) and the step's update (Momentum's first velocity is the
#: gradient) within 1e-3 in relative L1
OCR_LOSS_REL, OCR_UPDATE_REL = 1e-4, 1e-3
#: D: warpctc against F.ctc_loss on the same log-probs, feasible rows: the
#: losses within a relative 1e-4, the gradients' largest gap within 1e-3 of
#: their largest magnitude (1.1e-4 measured on an H100; a gradient that lost
#: a term or a path parts by 1e-1 and more)
OCR_CTC_RTOL, OCR_CTC_GRAD_REL = 1e-4, 1e-3
#: C: the cases whose captured call launches no kernel, (case, gradient):
#: views (``crop``, ``crop_tensor``, ``cvm`` with use_cvm off,
#: ``sequence_reshape``) and ``fill``'s constant, cached on the card
OCR_EMPTY_CAPTURES = {("crop", False), ("crop-like", False), ("crop_tensor", False),
                      ("crop_tensor-clamped", False), ("cvm-drop", False), ("fill", False),
                      ("fill-int", False), ("sequence_reshape", False),
                      ("sequence_reshape", True)}


def _ocr_feed(torch, cfg, batch, seed, device):
    from paddle_tpu_torch.tools import ocr
    return {k: torch.from_numpy(v).to(device) for k, v in ocr.crnn_feed(cfg, batch, seed).items()}


def _ocr_train(torch, pt):
    """A: CRNN-CTC at [1, 48, 512], batch 32, T 64, Momentum: 5 captured steps
    against the same 5 eager, bit for bit; step ms on both paths, device busy
    ms, idle share, launches a step, the graph's pool, multi_tensor_update's
    calls a step; step 1 at batch 2 against the CPU port. Returns the record
    and the startup state."""
    from paddle_tpu_torch.core.executor import capture_refusal
    from paddle_tpu_torch.tools import ocr
    cfg = ocr.CRNN
    t = ocr.build_crnn_ctc(pt, cfg, seed=SEED)
    why = capture_refusal(t.main)
    if why is not None:
        raise SystemExit(f"ocr A: the CRNN-CTC step is not captured: {why}")
    init = _startup_state(pt, t.main, t.startup)
    feeds = [_ocr_feed(torch, cfg, OCR_BATCH, SEED + 24 + k, "cuda") for k in range(OCR_STEPS)]
    launches = {}
    g, e, differs, ms, captured = _graph_vs_eager(torch, pt, t.main, feeds, [t.loss], init,
                                                  launches=launches)
    torch.cuda.empty_cache()
    if not captured:
        raise SystemExit("ocr A: no CUDA graph was captured for the CRNN-CTC step")
    losses = [float(o[0].reshape(())) for o in g]
    bit_equal = all(torch.equal(a[0], b[0]) for a, b in zip(g, e))
    if not (bit_equal and not differs):
        raise SystemExit(f"ocr A: the captured CRNN-CTC steps part from the eager ones: "
                         f"losses equal {bit_equal}, state {differs[:8]}")
    if not np.isfinite(losses).all():
        raise SystemExit(f"ocr A: CRNN-CTC losses not finite: {losses}")
    # the update ops group into one call a run of equal attrs: the biases'
    # learning rate 2.0 and the regularisers' ops between them make several
    mt = launches["graph"].get("multi_tensor_update", 0)
    if not mt or mt % OCR_STEPS or launches["eager"].get("multi_tensor_update", 0) != mt:
        raise SystemExit(f"ocr A: multi_tensor_update ran {launches} times, not the same "
                         f"number each step on both paths")
    timed = _timed_path(torch, pt, t.main, feeds[0], t.loss, init, graphs_on=True,
                        free_dead=True)
    # step 1 at batch 2, card against the CPU port, from the card's startup state
    step1 = {}
    for dev in ("cpu", "cuda"):
        scope = pt.Scope()
        for n, v in init.items():
            scope.set_var(n, v.to(dev, copy=True))
        with pt.scope_guard(scope):
            value = pt.Executor(pt.CPUPlace() if dev == "cpu" else None).run(
                t.main, feed=_ocr_feed(torch, cfg, 2, SEED + 2, dev), fetch_list=[t.loss])[0]
        # Momentum's first velocity is the gradient (with the L2 term)
        step1[dev] = (float(np.asarray(value).reshape(-1)[0]),
                      {n: scope.find_var(n).float().cpu() for n in init
                       if n.endswith("_velocity_0")})
    gaps = _resnet_gaps(step1["cuda"], step1["cpu"])
    flop = 3 * _crnn_forward_flop(cfg, OCR_BATCH)
    r = dict(model="CRNN-CTC (crnn_ctc_model.py)", image=list(cfg.image), batch=OCR_BATCH,
             steps_T=cfg.steps, classes=cfg.num_classes + 1, hidden=cfg.hidden,
             max_label=cfg.max_label, losses=losses, graph_bit_equal_to_eager=True,
             step_ms_graph=timed["step_ms_median_warm"],
             step_ms_graph_all=timed["step_ms"],
             step_ms_eager=statistics.median(ms["eager"][1:]), step_ms_eager_all=ms["eager"],
             device_busy_ms=timed["device_busy_ms"], idle_share=timed["idle_share_unprofiled"],
             idle_share_profiled=timed["idle_share_profiled"],
             launches_per_step=timed["device_activities_per_step"], by_kind=timed["by_kind"],
             graph_pool_gb=timed["graph_pool_gb"], peak_gb=timed["peak_gb"],
             multi_tensor_update_launches=launches,
             multi_tensor_update_calls_per_step=mt // OCR_STEPS, step_flop=flop,
             f32_bound_ms=flop / PEAK_FLOPS["float32"] * 1e3,
             step1_batch2=dict(gaps, loss_rel_limit=OCR_LOSS_REL,
                               update_rel_l1_limit=OCR_UPDATE_REL))
    emit("ocr_crnn_training", **r)
    if not (gaps["loss_rel_gap"] <= OCR_LOSS_REL and gaps["update_rel_l1_gap"] <= OCR_UPDATE_REL):
        raise SystemExit(f"ocr A: CRNN-CTC step 1 parts from the CPU port: {gaps}")
    return r, init


def _crnn_forward_flop(cfg, batch):
    """Multiply-adds x 2 of the CRNN forward: the convolutions, the two
    input fcs, the GRU cells' fcs over T steps each way, the output fc."""
    c_in, h, w = cfg.image
    flop = 0
    for g, chans in enumerate(cfg.groups):
        for ch in chans:
            flop += 2 * batch * h * w * ch * c_in * 9
            c_in = ch
        if g < len(cfg.groups) - 1:
            h, w = h // 2, w // 2
    feat, H, T = c_in * h, cfg.hidden, w
    flop += 2 * 2 * batch * T * feat * 3 * H                     # fc_1, fc_2
    flop += 2 * 2 * batch * T * ((3 * H + H) * 2 * H + (3 * H + H) * H)   # GRU cells
    flop += 2 * batch * T * 2 * H * (cfg.num_classes + 1)       # the output fc
    return flop


def _ocr_serve(torch, pt, workdir, init):
    """B: the decode program on a seeded state at a trained net's scales
    (``ocr.random_state`` over ``init``'s names; 5 steps of A leave every row
    decoding to blanks, which would make the comparison empty), saved and
    served by the port's Predictor at batch 1 and 32 (replays): every row
    decodes at least one token, and the served logits, ids and lengths equal
    the executor's on the card bit for bit; the on-card edit_distance of the
    batch-32 decode and of random rows equals a numpy Levenshtein exactly,
    normalized and not."""
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.tools import ocr
    from paddle_tpu_torch.tools.train_profile import traced
    from torch.profiler import ProfilerActivity
    cfg = ocr.CRNN
    dec = ocr.build_crnn_ctc(pt, cfg, train=False, seed=SEED)
    names = dec.main.global_block().vars
    served = ocr.random_state({n: v.cpu().numpy() for n, v in init.items() if n in names},
                              seed=SEED + 5)
    scope = pt.Scope()
    for n, v in served.items():
        scope.set_var(n, torch.from_numpy(v).cuda())
    model_dir = os.path.join(workdir, "crnn")
    fetch = [dec.decoded, dec.decoded_length, dec.logits]
    with pt.scope_guard(scope):
        pt.io.save_inference_model(model_dir, ["pixel", "logits_length"], fetch, pt.Executor(),
                                   main_program=dec.main)
    pred = Predictor(model_dir)
    rows = []
    for batch, warm in OCR_SERVE_WARM.items():
        raw = ocr.crnn_feed(cfg, batch, SEED + 40 + batch)
        req = {"pixel": raw["pixel"], "logits_length": raw["logits_length"]}
        t0 = time.perf_counter()
        cold = pred.run(req)
        cold_ms = (time.perf_counter() - t0) * 1e3
        misses = pred._cache_counts["miss"]
        lat = []
        for _ in range(warm):
            t0 = time.perf_counter()
            out = pred.run(req)
            lat.append((time.perf_counter() - t0) * 1e3)
        if pred._cache_counts["miss"] != misses:
            raise SystemExit("ocr B: a warm request captured a graph")
        torch.cuda.synchronize()
        with traced([ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                pred.run(req)
            torch.cuda.synchronize()
        acts = sum(e.count for e in prof.key_averages()
                   if getattr(e, "self_device_time_total", 0) > 0 and e.cpu_time_total == 0)
        busy = _device_busy_ms(prof) / 3
        exe = pt.Executor()
        exe._use_graphs = False
        with pt.scope_guard(scope):
            ids, lens, logits, dist = exe.run(dec.main, feed=raw,
                                              fetch_list=fetch + [dec.distance])
        same = all(np.array_equal(a, b) for a, b in zip(out, (ids, lens, logits))) and all(
            np.array_equal(a, b) for a, b in zip(out, cold))
        row = dict(batch=batch, cold_ms=cold_ms, p50_ms=statistics.median(lat), ms=lat,
                   device_busy_ms=busy, device_activities_per_request=acts / 3,
                   predictor_equals_executor=same,
                   logits_max_abs_gap=float(np.abs(out[2] - logits).max()),
                   decoded_lengths=[int(x) for x in lens],
                   mean_normalized_edit_distance=float(np.mean(dist)))
        emit("ocr_crnn_serving", **row)
        rows.append(row)
        if not lens.min() > 0:
            raise SystemExit(f"ocr B: rows decode to blanks only at batch {batch}, so the "
                             f"Predictor's decode is held to nothing: {row['decoded_lengths']}")
        if not same:
            raise SystemExit(f"ocr B: the Predictor's logits or decode part from the "
                             f"executor's at batch {batch}")
    # the evaluator on the card: the batch-32 decode and random rows at the
    # path's shapes
    nb = len(lens)
    rng = np.random.RandomState(SEED + 42)
    hyp_r = rng.randint(0, cfg.num_classes, (nb, cfg.steps))
    len_r = rng.randint(0, cfg.steps + 1, nb)
    checks = {}
    for which, hyp, hl in (("decode", ids, lens), ("random", hyp_r, len_r)):
        for normalized in (True, False):
            out = treg.get("edit_distance").lower(
                treg.LowerCtx({"normalized": normalized}, "cuda"),
                {"Hyps": [torch.from_numpy(np.asarray(hyp, np.int64)).cuda()],
                 "Refs": [torch.from_numpy(raw["label"]).cuda()],
                 "HypsLength": [torch.from_numpy(np.asarray(hl, np.int64)).cuda()],
                 "RefsLength": [torch.from_numpy(raw["label_length"]).cuda()]})["Out"][0]
            got = out.cpu().numpy()[:, 0]
            want = []
            for b in range(nb):
                ref = raw["label"][b, :raw["label_length"][b]]
                d = ocr.levenshtein(np.asarray(hyp)[b, :hl[b]], ref)
                want.append(np.float32(d / max(len(ref), 1)) if normalized else np.float32(d))
            checks[f"{which}_{'normalized' if normalized else 'raw'}"] = bool(
                np.array_equal(got, np.asarray(want, np.float32)))
    edit = dict(decoded_lengths=[int(x) for x in lens], exact=checks)
    emit("ocr_edit_distance_on_card", **edit)
    if not all(checks.values()):
        raise SystemExit(f"ocr B: edit_distance on the card parts from numpy: {checks}")
    shutil.rmtree(model_dir, ignore_errors=True)
    return rows, edit


def _extra_cases_on_card(torch, pt):
    """C: every case of tools/extra_op_cases.py on the card against the CPU
    port, forward and generic grad, at the case's tolerance; each forward
    and grad call captured in a CUDA graph with its launches counted; each
    ``scatters`` case run twice, bit for bit. ``py_func`` runs eagerly, and a
    program holding it is refused capture."""
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.core.executor import capture_refusal
    from paddle_tpu_torch.layers import extras as tx
    from paddle_tpu_torch.tools import extra_op_cases as xc
    from paddle_tpu_torch.tools.op_cases import numpy_outs

    def held(card, cpu, tol, what):
        worst = 0.0
        for slot, vals in cpu.items():
            for a, b in zip(numpy_outs({"x": vals})["x"], numpy_outs({"x": card[slot]})["x"]):
                if a is None:
                    continue
                if a.shape != b.shape or not np.allclose(b, a, equal_nan=True, **tol):
                    raise SystemExit(f"extra C: {what} {slot} parts from the CPU port "
                                     f"(max gap {np.abs(a.astype(np.float64) - b).max()})")
                if a.size:
                    worst = max(worst, float(np.abs(a.astype(np.float64) - b).max()))
        return worst

    def same_bits(a, b):
        return all(torch.equal(x, y) for s in a for x, y in zip(a[s], b[s]) if x is not None)

    def kernels(fn, case, grad=False):
        """Kernel launches of one call, captured; 0 for a case of
        OCR_EMPTY_CAPTURES, whose graph is empty (any other empty graph
        fails the phase)."""
        try:
            return _graph_nodes(torch, fn)[1]
        except SystemExit as e:
            if "names no node" not in str(e) or (case, grad) not in OCR_EMPTY_CAPTURES:
                raise
            return 0

    rows = []
    cases = dict(xc.CASES)
    cases["py_func"] = xc.py_func_case(tx._PYFUNC_TABLE)
    for name, c in sorted(cases.items()):
        cpu = xc.forward(c, "cpu")
        tins = xc._tensors(c.ins, "cuda")
        ctx = treg.LowerCtx(dict(c.attrs), "cuda")
        lower = treg.get(c.op).lower
        card = lower(ctx, tins)
        row = dict(case=name, op=c.op, forward_max_abs_err=held(card, cpu, c.tol, name))
        if c.op == "py_func":
            row["capture"] = "refused"
        else:
            row["forward_kernel_launches"] = kernels(lambda: lower(ctx, tins), name)
        if c.scatters:
            row["forward_bit_equal_twice"] = same_bits(card, lower(ctx, tins))
        if c.grad:
            gins, gattrs = xc.grad_inputs(c, cpu)
            glower = treg.get(c.op + "_grad").lower
            g_cpu = glower(treg.LowerCtx(gattrs, "cpu"), xc._tensors(gins, "cpu"))
            gtins = xc._tensors(gins, "cuda")
            gctx = treg.LowerCtx(gattrs, "cuda")
            g_card = glower(gctx, gtins)
            row["grad_max_abs_err"] = held(g_card, g_cpu, c.grad_tol, name + " grad")
            row["grad_kernel_launches"] = kernels(lambda: glower(gctx, gtins), name, grad=True)
            if c.scatters:
                row["grad_bit_equal_twice"] = same_bits(g_card, glower(gctx, gtins))
        rows.append(row)
        if c.scatters and not (row["forward_bit_equal_twice"]
                               and row.get("grad_bit_equal_twice", True)):
            raise SystemExit(f"extra C: {name} does not reproduce bit for bit on the card: {row}")
    # py_func in a program: refused capture, with its reason
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.data("x", [4], "float32")
        out = main.current_block().create_var("pyout", (-1, 4), "float32")
        pt.layers.py_func(lambda a: a * 2.0, x, out)
    why = capture_refusal(main)
    print(f"extra C: capture refused: {why}", flush=True)
    if why is None or "py_func" not in why:
        raise SystemExit(f"extra C: a py_func program was not refused capture: {why}")
    missing = xc.EXTRA_TYPES - {r["op"] for r in rows}
    emit("extra_op_cases_on_card", cases=len(rows), op_types=len({r["op"] for r in rows}),
         rows=rows, py_func_refusal=why)
    if missing:
        raise SystemExit(f"extra C: op types without a case on the card: {sorted(missing)}")
    return dict(rows=rows, py_func_refusal=why)


def _state_ops_captured(torch, pt):
    """C: data_norm, center_loss and spectral_norm writing their state back,
    and uniform_random_batch_size_like drawing, inside a captured SGD step
    (``extra_op_cases.build_state_program``, fc 512, 100 classes, batch
    256): 5 captured steps against 5 eager, bit for bit (fetches and state),
    the noise new at each replay, every state tensor moved."""
    from paddle_tpu_torch.core.executor import capture_refusal
    from paddle_tpu_torch.tools import extra_op_cases as xc
    main, startup, loss, noise = xc.build_state_program(pt, width=512, classes=100)
    if capture_refusal(main) is not None:
        raise SystemExit(f"extra C: the state program is refused: {capture_refusal(main)}")
    init = _startup_state(pt, main, startup)
    feed = {k: torch.from_numpy(v).cuda() for k, v in xc.state_feed(256, 100, SEED).items()}
    g, e, differs, ms, captured = _graph_vs_eager(torch, pt, main, [feed] * 5, [loss, noise],
                                                  init)
    bit_equal = all(torch.equal(a, b) for x, y in zip(g, e) for a, b in zip(x, y))
    redraws = all(not torch.equal(g[i][1], g[i + 1][1]) for i in range(4))
    r = dict(captured=captured, graph_eager_bit_equal=bit_equal and not differs,
             noise_new_each_replay=redraws, losses=[float(o[0].reshape(())) for o in g],
             step_ms_graph=statistics.median(ms["graph"][2:]))
    emit("extra_state_ops_captured", **r)
    if not (captured and bit_equal and not differs and redraws):
        raise SystemExit(f"extra C: the captured state program parts from eager: {r}, "
                         f"state {differs[:8]}")
    return r


def _ctc_yardstick(torch):
    """D: warpctc's forward + backward at the path's shape (B 32, T 64, 96
    classes, labels padded to 24, lengths 4-20) against F.ctc_loss
    (reduction='none') on the same log-probs: losses and gradients on the
    feasible rows within OCR_CTC_RTOL and OCR_CTC_GRAD_REL, and both times
    (CUDA events)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.tools import ocr
    cfg = ocr.CRNN
    B, T, C = OCR_BATCH, cfg.steps, cfg.num_classes + 1
    raw = ocr.crnn_feed(cfg, B, SEED + 43)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 43)
    logp = torch.log_softmax(torch.randn(B, T, C, generator=gen, device="cuda"), -1)
    label = torch.from_numpy(raw["label"]).cuda()
    ylen = torch.from_numpy(raw["label_length"]).cuda()
    xlen = torch.full((B,), T, dtype=torch.int64, device="cuda")
    lower = treg.get("warpctc").lower
    ctx = treg.LowerCtx({"blank": cfg.blank}, "cuda")

    def port():
        x = logp.detach().requires_grad_()
        loss = lower(ctx, {"Logits": [x], "Label": [label], "LogitsLength": [xlen],
                           "LabelLength": [ylen]})["Loss"][0]
        loss.sum().backward()
        return loss, x.grad

    def library():
        x = logp.detach().requires_grad_()
        loss = F.ctc_loss(x.transpose(0, 1), label, xlen, ylen, blank=cfg.blank,
                          reduction="none", zero_infinity=False)
        loss.sum().backward()
        return loss, x.grad

    (a, ga), (b, gb) = port(), library()
    feasible = torch.isfinite(b)
    gap = float(((a[:, 0] - b).abs() / b.abs())[feasible].max().detach())
    grad_gap = float((ga - gb)[feasible].abs().max())
    grad_max = float(gb[feasible].abs().max())
    ms, lib_ms = _device_ms(torch, port, runs=10), _device_ms(torch, library, runs=10)
    r = dict(shape=[B, T, C], max_label=cfg.max_label, feasible_rows=int(feasible.sum()),
             loss_rel_gap=gap, rtol=OCR_CTC_RTOL, grad_max_abs_gap=grad_gap,
             grad_max_abs=grad_max, grad_rel_limit=OCR_CTC_GRAD_REL,
             warpctc_fwd_bwd_ms=ms, ctc_loss_fwd_bwd_ms=lib_ms)
    emit("ocr_ctc_yardstick", **r)
    if not (int(feasible.sum()) and gap <= OCR_CTC_RTOL
            and grad_gap <= OCR_CTC_GRAD_REL * grad_max):
        raise SystemExit(f"ocr D: warpctc parts from F.ctc_loss: {r}")
    return r


def phase_ocr(torch, workdir):
    """Phase 24: CRNN-CTC trained (A) and served (B) on the card, the cases of
    every op type of ROADMAP item 8 on the card (C), warpctc beside
    F.ctc_loss (D)."""
    import paddle_tpu_torch as pt
    t0 = time.perf_counter()
    train, init = _ocr_train(torch, pt)
    torch.cuda.empty_cache()
    serving, edit = _ocr_serve(torch, pt, workdir, init)
    del init
    torch.cuda.empty_cache()
    cases = _extra_cases_on_card(torch, pt)
    cases["state_ops_captured"] = _state_ops_captured(torch, pt)
    torch.cuda.empty_cache()
    yard = _ctc_yardstick(torch)
    emit("ocr", seconds=time.perf_counter() - t0)
    return dict(train=train, serving=serving, edit=edit, cases=cases, yardstick=yard,
                seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------------------
# Phase 25: the measurement stack
# ---------------------------------------------------------------------------------------

# A: phase 11's BERT-base step under PADDLE_TPU_OBS=1: MEAS_STEPS warm steps after the
# warm-up and the capture, one async checkpoint save after warm step MEAS_SAVE_AFTER,
# and one hang at the dispatch site at run counter MEAS_HANG_STEP, about 5 warm steps
# long (the detector gives verdicts from its 8th warm sample on)
MEAS_STEPS, MEAS_SAVE_AFTER, MEAS_HANG_STEP, MEAS_HANG_S = 20, 2, 15, 0.45
# the goodput causes against the wall, and program_flops against the hand count
MEAS_SUM_REL, MEAS_FLOPS_REL = 0.01, 0.01
# C: one client, single-row S 128 requests on a tenant of its own (earlier phases'
# tenants keep their own histograms, and their own alerts); MEAS_CLEAN before the
# hang, then requests under it until MEAS_SLOW of them waited out a hung worker
# tick (each sleeps MEAS_SLOW_S; the other worker may serve a request at once):
# the slow ones are over 1% of the tenant's histogram, so the p99 is theirs; then
# 100 requests for each slow one and MEAS_CLEAN more, under 1%, so it is the
# fast requests' again
MEAS_TENANT, MEAS_CLEAN, MEAS_SLOW, MEAS_SLOW_S = "measurement", 100, 3, 0.3
MEAS_P99_S = 0.05                      # the rule: p99 <= 50 ms
MEAS_PROFILED_STEPS = 3                # D


def _bert_hand_flops(cfg, B, S, M) -> int:
    """BERT pretraining's matmul FLOPs a step, counted by hand: each encoder
    layer's QKV, output and two FFN products over B*S tokens and its two
    attention products; the MLM head's transform and tied decoder over M
    masked tokens, the pooler and the NSP classifier over B rows; backward
    twice the forward."""
    T, H, F, V = B * S, cfg.hidden, cfg.ffn_hidden, cfg.vocab_size
    layer = 2 * T * H * 3 * H + 2 * T * H * H + 2 * 2 * T * H * F + 2 * 2 * B * S * S * H
    head = 2 * M * H * H + 2 * M * H * V + 2 * B * H * H + 2 * B * H * 2
    return 3 * (cfg.n_layers * layer + head)


def _meas_training(torch, pt, workdir):
    """A and B: the goodput ledger, cost, memory and the detector over BERT-base
    training, and the attribution of its capture miss."""
    from paddle_tpu_torch.core import cuda_build
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.observability import REGISTRY, attribution, goodput, journal
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.tools.train_profile import (BATCH, LR, MASKS_PER_SEQ, SEQ,
                                                      build_pretrain, pretrain_feed)
    from paddle_tpu_torch.utils.checkpointer import Checkpointer
    from paddle_tpu_torch.utils.flops import program_flops
    cfg = bert.BertConfig(dtype="bfloat16", dropout=ATTN_DROPOUT)
    main, startup, total, _ = build_pretrain(cfg, BATCH, SEQ, MASKS_PER_SEQ, LR, SEED)
    feed = pretrain_feed(np.random.RandomState(SEED), cfg, BATCH, SEQ, MASKS_PER_SEQ)
    feed = {k: torch.from_numpy(v).cuda() for k, v in feed.items()}
    label = f"{id(main)}:v{main._version}"
    exe = pt.Executor()
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe.run(startup)
        main._rng_run_counter = 0
        ck = Checkpointer(exe, main, os.path.join(workdir, "ckpt"), async_save=True)
        faults.install(f"hang@dispatch:step={MEAS_HANG_STEP}:seconds={MEAS_HANG_S}")
        try:
            with goodput.run_ledger() as led:
                for i in range(2 + MEAS_STEPS):
                    if i == 2:          # after the warm-up and the capture: the warm steps
                        torch.cuda.synchronize()
                        for f in cuda_build.COUNTED:
                            f.launches = 0
                    exe.run(main, feed=feed, fetch_list=[total], return_numpy=False)
                    if i == 2 + MEAS_SAVE_AFTER:
                        ck.save(main._rng_run_counter - 1)
                torch.cuda.synchronize()
                launches = {f.__name__: f.launches for f in cuda_build.COUNTED if f.launches}
                ck.wait()
        finally:
            faults.clear()
            ck.close()
    report = led.report().to_dict()
    causes_sum = sum(report["breakdown_seconds"].values())
    # the detector's verdicts: each anomaly event precedes its step's run event
    events = journal.recent()
    runs = [e for e in events if e.get("event") == "run" and e.get("program") == id(main)]
    flagged = []
    for j, e in enumerate(events):
        if e.get("event") == "step_time_anomaly" and e.get("program") == label:
            nxt = next(x for x in events[j + 1:] if x.get("event") == "run"
                       and x.get("program") == id(main))
            flagged.append(runs.index(nxt))
    g = lambda name: REGISTRY.gauge(name, program=label).value  # noqa: E731
    step = next(s for k, s in exe._cache.items() if k[0] == id(main))
    flops = program_flops(main, BATCH)
    hand = _bert_hand_flops(cfg, BATCH, SEQ, BATCH * MASKS_PER_SEQ)
    warm_ms = [e["run_ms"] for e in runs if e["cache"] == "hit"]
    a = dict(model=f"bert-base pretrain bf16 B{BATCH} S{SEQ} dropout {cfg.dropout} "
                   f"Adam({LR}), captured, PADDLE_TPU_OBS=1",
             warm_steps=MEAS_STEPS,
             goodput=dict(fraction=report["goodput_fraction"],
                          causes_s=report["breakdown_seconds"], wall_s=report["wall_seconds"],
                          causes_sum_s=causes_sum,
                          overaccounted_s=report["overaccounted_seconds"],
                          median_step_ms=report["median_step_ms"],
                          sources=report["sources"]),
             program_flops=flops, hand_count_flops=hand,
             program_flops_rel_gap=abs(flops["total"] - hand) / hand,
             program_mfu=g("program_mfu"), peak_flops=step.cost.peak, product_dtype=step.cost.dtype,
             program_flops_per_sec=g("program_flops_per_sec"),
             memory=dict(program_peak_bytes=g("program_peak_bytes"),
                         program_argument_bytes=g("program_argument_bytes"),
                         program_output_bytes=g("program_output_bytes"),
                         device_memory_bytes_in_use=REGISTRY.gauge(
                             "device_memory_bytes_in_use", device="cuda:0").value,
                         device_memory_peak_bytes=REGISTRY.gauge(
                             "device_memory_peak_bytes", device="cuda:0").value),
             warm_step_ms=warm_ms, hang_step=MEAS_HANG_STEP, flagged_steps=flagged,
             launches_per_warm_step={k: v / MEAS_STEPS for k, v in launches.items()},
             launches=launches,
             ckpt_blocked_ms=[e["blocked_ms"] for e in events if e.get("event") == "ckpt_save"])
    emit("measurement_training", **a)

    # B: the attribution of A's capture miss (its eager warm-up, profiled)
    attrib = attribution.lookup_program(main)
    if attrib is None:
        raise SystemExit("phase 25 B: A's capture miss was not attributed")
    k1 = {"fwd": "flash_fwd_bf16_kernel", "bwd": ("bwd_dkdv_bf16_kernel", "bwd_dq_bf16_kernel")}
    placed = {"fwd": {}, "bwd": {}}
    for ir, row in attrib.per_ir.items():
        for name, secs in row["names"].items():
            for which, frag in k1.items():
                if any(f in name for f in ((frag,) if isinstance(frag, str) else frag)):
                    op = ir.split("#")[0]
                    placed[which][op] = placed[which].get(op, 0.0) + secs
    b = dict(program=label, device_seconds=attrib.total_device_seconds,
             attributed_device_fraction=attrib.coverage,
             per_category_ms={c: v["device_seconds"] * 1e3
                              for c, v in attrib.per_category.items()},
             top10=[{"op": ir, "device_ms": v["device_seconds"] * 1e3,
                     "categories": sorted(v["categories"]), "kernels": v["kernels"],
                     "tensor_bytes": v["tensor_bytes"]} for ir, v in attrib.top_ops(10)],
             attention_ops_ranked=[
                 {"rank": i + 1, "op": ir, "device_ms": v["device_seconds"] * 1e3}
                 for i, (ir, v) in enumerate(attrib.top_ops(len(attrib.per_ir)))
                 if ir.split("#")[0] in ("fused_attention", "fused_attention_grad")][:4],
             k1_fwd_ms_by_op_type={k: v * 1e3 for k, v in placed["fwd"].items()},
             k1_bwd_ms_by_op_type={k: v * 1e3 for k, v in placed["bwd"].items()},
             fused_attention_ops=sum(1 for ir in attrib.per_ir
                                     if ir.startswith("fused_attention#")),
             fused_attention_grad_ops=sum(1 for ir in attrib.per_ir
                                          if ir.startswith("fused_attention_grad#")))
    emit("measurement_attribution", **b)

    # checks
    if abs(causes_sum - report["wall_seconds"]) > MEAS_SUM_REL * report["wall_seconds"]:
        raise SystemExit(f"phase 25 A: the goodput causes sum to {causes_sum} s, the wall "
                         f"is {report['wall_seconds']} s")
    if a["program_flops_rel_gap"] > MEAS_FLOPS_REL:
        raise SystemExit(f"phase 25 A: program_flops {flops} against the hand count {hand}")
    if not 0 < a["program_mfu"] < 1:
        raise SystemExit(f"phase 25 A: program_mfu {a['program_mfu']} outside (0, 1)")
    if flagged != [MEAS_HANG_STEP]:
        raise SystemExit(f"phase 25 A: the detector flagged steps {flagged}, expected only "
                         f"the hang's {MEAS_HANG_STEP}")
    per_step = a["launches_per_warm_step"]
    if per_step.get("flash_attn_fwd") != cfg.n_layers or \
            per_step.get("flash_attn_bwd") != cfg.n_layers:
        raise SystemExit(f"phase 25 A: K1 launches a warm step {per_step}")
    if not all(a["memory"][k] > 0 for k in ("program_peak_bytes", "program_argument_bytes",
                                            "program_output_bytes")):
        raise SystemExit(f"phase 25 A: a memory gauge is unset: {a['memory']}")
    if set(placed["fwd"]) != {"fused_attention"} or \
            set(placed["bwd"]) != {"fused_attention_grad"}:
        raise SystemExit(f"phase 25 B: K1's kernels are attributed to {placed}")
    if (b["fused_attention_ops"], b["fused_attention_grad_ops"]) != (cfg.n_layers,
                                                                     cfg.n_layers):
        raise SystemExit(f"phase 25 B: attention ops attributed {b}")
    return a, b, (exe, scope, main, feed, total)


def _meas_serving(torch, pt, workdir):
    """C: BERT-base behind PredictorPool with SLO rules; a serve_hang fires the
    p99 rule, and it resolves once the hang is gone; /alerts and /goodput."""
    import urllib.request
    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.observability import goodput, journal, server, slo, timeline
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.serving import PredictorPool
    from paddle_tpu_torch.serving.__main__ import ulps_apart
    from paddle_tpu_torch.tools.serving_profile import bert_feed, save_bert_encoder
    cfg = BertConfig(dtype="bfloat16")
    model_dir = os.path.join(workdir, "bert_slo")
    save_bert_encoder(model_dir, cfg, SEED)
    rng = np.random.RandomState(SEED + 25)
    feeds = [bert_feed(rng, 1, 128, cfg.vocab_size) for _ in range(8)]
    solo_pred = Predictor(model_dir)
    solo = [solo_pred.run(f)[0] for f in feeds]
    del solo_pred
    rules = os.path.join(workdir, "slo_rules.json")
    with open(rules, "w") as f:
        json.dump({"format": "paddle_tpu_slo_rules_v1", "rules": [
            {"id": "serve-p99", "metric": "serving_request_seconds{tenant}",
             "objective": f"p99 <= {MEAS_P99_S * 1e3:g}ms", "severity": "page"},
            {"id": "no-nonfinite", "metric": "tensor_nonfinite_total",
             "objective": "== 0", "severity": "page"}]}, f)
    os.environ.update(PADDLE_TPU_OBS_SLO=rules, PADDLE_TPU_OBS_SLO_INTERVAL="3600",
                      PADDLE_TPU_OBS_PORT="0")
    compile_before = sum(s[3] for s in timeline.spans("compile"))
    pool = PredictorPool(model_dir, size=POOL_SIZE, max_batch=POOL_MAX_BATCH,
                         max_wait_ms=POOL_MAX_WAIT_MS)
    transitions, served, worst, equal, latency = [], 0, 0.0, 0, []
    try:
        engine = slo.ENGINE
        if engine is None or server.current() is None:
            raise SystemExit("phase 25 C: the pool armed no SLO engine or endpoint")
        warmed = pool.warmup(feeds[0])
        warm_compile_s = sum(s[3] for s in timeline.spans("compile")) - compile_before

        def traffic(n, part):
            nonlocal served, worst, equal
            for _ in range(n):
                i = served % len(feeds)
                t_req = time.perf_counter()
                out = pool.run(feeds[i], tenant=MEAS_TENANT, timeout=120)[0]
                latency.append((part, time.perf_counter() - t_req))
                equal += out.tobytes() == solo[i].tobytes()
                worst = max(worst, ulps_apart(out.reshape(-1, cfg.hidden),
                                              solo[i].reshape(-1, cfg.hidden), "bfloat16"))
                served += 1

        def evaluate(t, phase):
            active = engine.evaluate(now=float(t))
            transitions.append({"t": t, "phase": phase,
                                "active": [(a.rule, a.severity, a.labels, round(a.observed, 4))
                                           for a in active]})
            # this phase's tenant only: the others' histograms are earlier phases'
            return {a.rule for a in active if a.labels.get("tenant") == MEAS_TENANT}

        traffic(MEAS_CLEAN, "clean")
        before = evaluate(0, "clean")
        faults.install(f"hang@serve_hang:seconds={MEAS_SLOW_S}:times=0")
        try:
            while sum(p == "hang" and s > MEAS_SLOW_S / 2 for p, s in latency) < MEAS_SLOW:
                if sum(p == "hang" for p, _ in latency) >= 20 * MEAS_SLOW:
                    raise SystemExit("phase 25 C: serve_hang slowed no request")
                traffic(1, "hang")
        finally:
            faults.clear()
        time.sleep(2 * MEAS_SLOW_S)     # the workers' last hung ticks end
        during = evaluate(1, "serve_hang")
        traffic(100 * MEAS_SLOW + MEAS_CLEAN, "after")
        after = evaluate(2, "after")
        resolved = [a.to_dict() for a in engine.alerts.history()
                    if a.labels.get("tenant") == MEAS_TENANT]
        fired = [e for e in journal.recent(event="alert")
                 if e["labels"].get("tenant") == MEAS_TENANT]
        url = server.current().url
        with urllib.request.urlopen(url + "/alerts", timeout=30) as r:
            alerts_code, alerts_body = r.status, json.loads(r.read())
        with urllib.request.urlopen(url + "/goodput", timeout=30) as r:
            goodput_code, goodput_body = r.status, json.loads(r.read())
        alerts_doc = json.loads(json.dumps(slo.alerts_doc(), sort_keys=True, default=str))
        ledger = goodput.compute_live().to_dict()
    finally:
        pool.close(drain_timeout=30.0)
        slo.disarm()
        server.stop()
        for k in ("PADDLE_TPU_OBS_SLO", "PADDLE_TPU_OBS_SLO_INTERVAL", "PADDLE_TPU_OBS_PORT"):
            os.environ.pop(k, None)
    ms = sorted(t * 1e3 for p, t in latency if p != "hang")
    c = dict(requests=served, byte_equal_to_solo=equal, max_ulps_to_solo=worst,
             tenant=MEAS_TENANT, clean_p50_ms=ms[len(ms) // 2],
             clean_p99_ms=ms[int(0.99 * (len(ms) - 1))],
             hung_ms=[t * 1e3 for p, t in latency if p == "hang"],
             warmed=warmed, warmup_compile_s=warm_compile_s,
             ledger_compile_s=ledger["breakdown_seconds"]["compile"],
             transitions=transitions,
             alert_events=[{k: e[k] for k in ("state", "rule", "severity", "observed")}
                           for e in fired],
             resolved=[{k: a[k] for k in ("rule", "severity", "observed")} for a in resolved],
             alerts_status=alerts_code, goodput_status=goodput_code,
             alerts_equal_doc=alerts_body == alerts_doc, goodput_equal_ledger=goodput_body == ledger,
             goodput_fraction=ledger["goodput_fraction"])
    emit("measurement_serving", **c)
    if before or during != {"serve-p99"} or after:
        raise SystemExit(f"phase 25 C: the p99 rule did not fire under the hang and resolve "
                         f"after it: {transitions}")
    if not any(e["state"] == "firing" and e["severity"] == "page" for e in c["alert_events"]) \
            or not any(a["rule"] == "serve-p99" for a in c["resolved"]):
        raise SystemExit(f"phase 25 C: no page fired and resolved: {c['alert_events']}")
    if (alerts_code, goodput_code) != (200, 200) or not (c["alerts_equal_doc"]
                                                         and c["goodput_equal_ledger"]):
        raise SystemExit(f"phase 25 C: /alerts or /goodput: {alerts_code} {goodput_code}, "
                         f"equal {c['alerts_equal_doc']} {c['goodput_equal_ledger']}")
    if equal != served:
        raise SystemExit(f"phase 25 C: {served - equal} of {served} pooled outputs differ from "
                         f"their solo runs (farthest {worst} ULPs)")
    if not warm_compile_s > 0 or c["ledger_compile_s"] < warm_compile_s:
        raise SystemExit(f"phase 25 C: the pool's warm-up captures are not the ledger's "
                         f"compile: {warm_compile_s} s captured, {c['ledger_compile_s']} s")
    return c


def _meas_profiler(torch, pt, workdir, trained):
    """D: fluid.profiler around MEAS_PROFILED_STEPS captured steps of A; the
    exported trace holds K1's kernels and the executor's spans on one clock. A
    new signature's warm-up inside the window is not attributed (one session)."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.observability import journal, timeline
    exe, scope, main, feed, total = trained
    tdir = os.path.join(workdir, "profile")
    out = os.path.join(workdir, "timeline.json")
    flags.set_flag("profile_executor", True)
    t_start = time.perf_counter()
    try:
        with pt.scope_guard(scope):
            with pt.profiler.profiler("All", "total", os.path.join(workdir, "summary.txt"),
                                      trace_dir=tdir):
                for _ in range(MEAS_PROFILED_STEPS):
                    exe.run(main, feed=feed, fetch_list=[total])
                # a new signature (another fetch list): its warm-up finds the session
                exe.run(main, feed=feed, fetch_list=[total, main.global_block().ops[0]
                                                     .output_arg_names()[0]])
    finally:
        flags.set_flag("profile_executor", False)
        exe.close()
    pt.profiler.export_chrome_tracing(tdir, out)
    events = timeline.validate_trace(out)
    mine = [e for e in events if e.get("pid") == timeline.PID_PHASES and e.get("ph") == "X"
            and e.get("name") in ("dispatch", "fetch_sync")
            and (e.get("args") or {}).get("program") == f"{id(main)}:v{main._version}"]
    mine = mine[-2 * (MEAS_PROFILED_STEPS + 1):]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kernels if "flash_fwd_bf16_kernel" in e["name"]
          or "bwd_dkdv_bf16_kernel" in e["name"] or "bwd_dq_bf16_kernel" in e["name"]]
    lo = min(e["ts"] for e in mine)
    hi = max(e["ts"] + e["dur"] for e in mine)
    inside = sum(1 for e in k1 if lo <= e["ts"] and e["ts"] + e["dur"] <= hi)
    # where a kernel outside lies: ms before the window (< 0) or after it
    outside_ms = [round(min(e["ts"] - lo, 0.0) / 1e3 or (e["ts"] + e["dur"] - hi) / 1e3, 3)
                  for e in k1 if not (lo <= e["ts"] and e["ts"] + e["dur"] <= hi)]
    skipped = journal.recent(event="attribution_skipped")
    with open(os.path.join(workdir, "summary.txt")) as f:
        summary = f.read()
    d = dict(steps=MEAS_PROFILED_STEPS, trace_events=len(events), kernels=len(kernels),
             k1_kernels=len(k1), k1_inside_executor_spans=inside, k1_outside_ms=outside_ms,
             executor_spans=len(mine), span_window_ms=(hi - lo) / 1e3,
             attribution_skipped=[e["reason"] for e in skipped][-1:],
             summary=summary.splitlines()[:4], seconds=time.perf_counter() - t_start)
    emit("measurement_profiler", **d)
    if not k1 or inside != len(k1) or len(mine) < 2 * MEAS_PROFILED_STEPS:
        raise SystemExit(f"phase 25 D: K1's kernels and the executor's spans are not on one "
                         f"clock: {d}")
    if not skipped:
        raise SystemExit("phase 25 D: a warm-up inside the profiler's session was not "
                         "skipped by the attribution")
    return d


def phase_measurement_stack(torch, workdir):
    """Phase 25: the measurement stack on BERT-base: goodput, cost and MFU,
    memory, the detector (A); the attribution of A's capture miss (B); SLOs and
    alerts behind the serving pool (C); fluid.profiler's trace (D)."""
    import paddle_tpu_torch as pt
    t0 = time.perf_counter()
    os.environ.update(PADDLE_TPU_OBS="1",
                      PADDLE_TPU_OBS_JOURNAL=os.path.join(workdir, "journal.jsonl"))
    try:
        a, b, trained = _meas_training(torch, pt, workdir)
        d = _meas_profiler(torch, pt, workdir, trained)
    finally:
        for k in ("PADDLE_TPU_OBS", "PADDLE_TPU_OBS_JOURNAL"):
            os.environ.pop(k, None)
    program = trained[2]   # phase 26 D reads its attribution
    del trained
    torch.cuda.empty_cache()
    # C needs no journal file and no synchronous timing: the engine reads the
    # registry, the ledger the in-memory ring and spans
    c = _meas_serving(torch, pt, workdir)
    torch.cuda.empty_cache()
    r = dict(a=a, b=b, c=c, d=d, program=program, seconds=time.perf_counter() - t0)
    emit("measurement_stack", seconds=r["seconds"])
    return r


ANALYSIS_BUDGET, ANALYSIS_TIGHT_BUDGET = "40G", "8G"   # B fits, C cannot
ANALYSIS_REPLAYS = 5
#: the band the JAX package's tests hold its planner to against XLA
#: (tests/test_analysis_distributed.py:639-669); a ratio outside it is a
#: finding to record, not a failure
ANALYSIS_RATIO_BAND = (0.5, 2.0)


def _analysis_programs(pt):
    """A's programs, each as its phase builds it: (name, program, fetch names)."""
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.tools import ocr
    from paddle_tpu_torch.tools.train_profile import (BATCH, LR, MASKS_PER_SEQ, NMT_BATCH,
                                                      NMT_LR, NMT_SEQ, SEQ, build_deepfm,
                                                      build_pretrain, build_resnet50,
                                                      build_transformer, transformer_config)
    bert = build_pretrain(BertConfig(dtype="bfloat16", dropout=ATTN_DROPOUT), BATCH, SEQ,
                          MASKS_PER_SEQ, LR, SEED)
    resnet = build_resnet50()
    nmt = build_transformer(transformer_config(), NMT_BATCH, NMT_SEQ, NMT_LR, SEED)
    deepfm = build_deepfm()
    yolo = _yolo_programs(pt)
    crnn = ocr.build_crnn_ctc(pt, ocr.CRNN, seed=SEED)
    return bert, [("bert-base pretrain B128 S128", bert[0], [bert[2].name]),
                  ("resnet50 B dynamic 224", resnet[0], [resnet[2].name]),
                  ("transformer-base B64 S64", nmt[0], [nmt[2].name]),
                  ("deepfm B4096 1M rows", deepfm[0], [deepfm[2].name, deepfm[3].name]),
                  ("yolov3 608 80 classes", yolo[0], [yolo[2].name]),
                  ("crnn-ctc 48x512", crnn.main, [crnn.loss.name])]


def _analysis_verify_zoo(pt, programs):
    """A: each program verified with its fetches; zero errors."""
    from collections import Counter
    from paddle_tpu_torch import analysis
    rows = []
    for name, prog, fetch in programs:
        t0 = time.perf_counter()
        diags = analysis.verify(prog, fetch_names=fetch)
        secs = time.perf_counter() - t0
        rows.append(dict(program=name, ops=len(prog.global_block().ops),
                         findings=dict(sorted(Counter(d.code for d in diags).items())),
                         errors=[d.format() for d in diags if d.severity == "error"][:5],
                         verify_s=secs))
    emit("analysis_programs", rows=rows)
    bad = [r for r in rows if r["errors"]]
    if bad:
        raise SystemExit(f"phase 26 A: error findings in {bad}")
    return rows


def _analysis_gate(torch, pt, bert):
    """B and C: BERT-base under the gate with a budget it fits, then a fresh
    copy of the program under one it cannot."""
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.core import cuda_build
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.observability import REGISTRY, goodput, journal, timeline
    from paddle_tpu_torch.tools.train_profile import BATCH, MASKS_PER_SEQ, SEQ, pretrain_feed
    main, startup, total, _ = bert
    cfg = BertConfig(dtype="bfloat16", dropout=ATTN_DROPOUT)
    feed = pretrain_feed(np.random.RandomState(SEED), cfg, BATCH, SEQ, MASKS_PER_SEQ)
    feed = {k: torch.from_numpy(v).cuda() for k, v in feed.items()}
    label = f"{id(main)}:v{main._version}"
    mine = lambda evs, p: [e for e in evs if e.get("program") == id(p)]  # noqa: E731
    exe, scope = pt.Executor(), pt.Scope()
    try:
        with pt.scope_guard(scope):
            exe.run(startup)
            main._rng_run_counter = 0
            os.environ.update(PADDLE_TPU_VALIDATE="raise", PADDLE_TPU_MEM_BUDGET=ANALYSIS_BUDGET)
            with goodput.run_ledger() as led:
                exe.run(main, feed=feed, fetch_list=[total], return_numpy=False)   # the miss
                torch.cuda.synchronize()
                events1 = len(mine(journal.recent(event="verify"), main))
                spans1 = [s for s in timeline.spans("verify") if s[4]["program"] == id(main)]
                for f in cuda_build.COUNTED:
                    f.launches = 0
                for _ in range(ANALYSIS_REPLAYS):   # the first captures, then each replays
                    loss, = exe.run(main, feed=feed, fetch_list=[total])
                torch.cuda.synchronize()
                launches = {f.__name__: f.launches for f in cuda_build.COUNTED if f.launches}
            events = mine(journal.recent(event="verify"), main)
            spans = [s for s in timeline.spans("verify") if s[4]["program"] == id(main)]
            captured = sum(1 for k, st in exe._cache.items()
                           if k[0] == id(main) and st.graph is not None)
            g = lambda n: REGISTRY.gauge(n, program=label).value  # noqa: E731
            est = analysis.estimate_program_memory(main, feed_names=list(feed),
                                                   fetch_names=[total.name])
            report = led.report().to_dict()
            b = dict(model=f"bert-base pretrain bf16 B{BATCH} S{SEQ} dropout {ATTN_DROPOUT} "
                           f"Adam, captured, PADDLE_TPU_VALIDATE=raise "
                           f"PADDLE_TPU_MEM_BUDGET={ANALYSIS_BUDGET}",
                     replays=ANALYSIS_REPLAYS, loss=float(loss[0]),
                     verify_events=len(events), verify_spans=len(spans),
                     verify_events_after_miss=len(events) - events1,
                     verify_spans_after_miss=len(spans) - len(spans1),
                     verify_findings={k: events[0][k] for k in ("error", "warn", "info")}
                     if events else None,
                     verify_span_s=spans[0][3] if spans else None,
                     ledger_verify_s=report["breakdown_seconds"]["verify"],
                     launches=launches,
                     launches_per_replay={k: v / ANALYSIS_REPLAYS for k, v in launches.items()},
                     graphs_captured=captured,
                     static_peak_bytes=g("program_static_peak_bytes"),
                     estimate_bytes=est.peak_bytes, estimate=est.summary(3),
                     argument_bytes=g("program_argument_bytes"),
                     pool_bytes=g("program_peak_bytes"),
                     static_peak_ratio=g("program_static_peak_ratio"),
                     ratio_band=list(ANALYSIS_RATIO_BAND))
            b["ratio_in_band"] = ANALYSIS_RATIO_BAND[0] <= b["static_peak_ratio"] \
                <= ANALYSIS_RATIO_BAND[1]
            emit("analysis_gate", **b)

            # C: a fresh program (a copy of B's) under a budget the step cannot meet
            fresh = main.clone()
            before = {n: v.clone() for n, v in scope._vars.items()
                      if isinstance(v, torch.Tensor)}
            os.environ["PADDLE_TPU_MEM_BUDGET"] = ANALYSIS_TIGHT_BUDGET
            for f in cuda_build.COUNTED:
                f.launches = 0
            raised = None
            try:
                exe.run(fresh, feed=feed, fetch_list=[total])
            except analysis.VerificationError as e:
                raised = e
            torch.cuda.synchronize()
            c_launches = {f.__name__: f.launches for f in cuda_build.COUNTED if f.launches}
            after = {n: v for n, v in scope._vars.items() if isinstance(v, torch.Tensor)}
            changed = sorted(n for n in set(before) | set(after)
                             if n not in before or n not in after
                             or not torch.equal(before[n], after[n]))
            c = dict(budget=ANALYSIS_TIGHT_BUDGET,
                     raised=type(raised).__name__ if raised is not None else None,
                     codes=sorted({d.code for d in raised.diagnostics}) if raised else None,
                     pt051=[d.message for d in raised.diagnostics
                            if d.code == "PT051"][:1] if raised else None,
                     launches=c_launches,
                     cache_entries=sum(1 for k in exe._cache if k[0] == id(fresh)),
                     state_tensors=len(before), state_changed=changed[:5])
            emit("analysis_budget", **c)
            del before, after
    finally:
        for k in ("PADDLE_TPU_VALIDATE", "PADDLE_TPU_MEM_BUDGET"):
            os.environ.pop(k, None)
        exe.close()
    n_layers = cfg.n_layers
    if (b["verify_events"], b["verify_spans"]) != (1, 1) or b["verify_events_after_miss"] \
            or b["verify_spans_after_miss"]:
        raise SystemExit(f"phase 26 B: verify events / spans {b}")
    if not 0 < b["ledger_verify_s"] or abs(b["ledger_verify_s"] - b["verify_span_s"]) > 2e-6:
        raise SystemExit(f"phase 26 B: the ledger's verify cause {b['ledger_verify_s']} s "
                         f"against the span's {b['verify_span_s']} s")
    per = b["launches_per_replay"]
    if per.get("flash_attn_fwd") != n_layers or per.get("flash_attn_bwd") != n_layers \
            or b["graphs_captured"] != 1:
        raise SystemExit(f"phase 26 B: K1 launches a replay {per}, graphs {b['graphs_captured']}")
    if b["static_peak_bytes"] != b["estimate_bytes"]:
        raise SystemExit(f"phase 26 B: program_static_peak_bytes {b['static_peak_bytes']} "
                         f"against the estimate {b['estimate_bytes']}")
    if not (np.isfinite(b["static_peak_ratio"]) and b["static_peak_ratio"] > 0
            and np.isfinite(b["loss"])):
        raise SystemExit(f"phase 26 B: ratio {b['static_peak_ratio']}, loss {b['loss']}")
    if c["raised"] != "VerificationError" or "PT051" not in c["codes"] or c["launches"] \
            or c["cache_entries"] or c["state_changed"]:
        raise SystemExit(f"phase 26 C: {c}")
    return b, c


def _analysis_layout_churn(program):
    """D: PT060 over phase 25 B's attribution of the BERT warm-up."""
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.analysis import layout_churn
    from paddle_tpu_torch.observability import attribution
    attrib = attribution.lookup_program(program)
    if attrib is None:
        raise SystemExit("phase 26 D: phase 25 B's attribution is gone")
    t0 = time.perf_counter()
    diags = analysis.verify(program, passes=["layout_churn"])
    secs = time.perf_counter() - t0
    copy = sorted(((row["categories"].get("copy", 0.0), ir)
                   for ir, row in attrib.per_ir.items()), reverse=True)
    d = dict(attributed_device_ms=attrib.attributed_device_seconds * 1e3,
             copy_ms=attrib.per_category.get("copy", {}).get("device_seconds", 0.0) * 1e3,
             floor_ms=max(layout_churn.MIN_OP_SECONDS, layout_churn.MIN_OP_FRACTION
                          * attrib.attributed_device_seconds) * 1e3,
             top_copy_ops=[{"op": ir, "copy_ms": secs_ * 1e3} for secs_, ir in copy[:5]],
             pt060=[{"op": attribution.ir_key(x.op_type, x.block_idx, x.op_idx),
                     "message": x.message} for x in diags],
             verify_s=secs)
    emit("analysis_layout_churn", **d)
    for x in diags:
        ir = attribution.ir_key(x.op_type, x.block_idx, x.op_idx)
        if x.code != "PT060" or ir not in attrib.per_ir or \
                program.blocks[x.block_idx].ops[x.op_idx].type != x.op_type:
            raise SystemExit(f"phase 26 D: {x.format()} names no attributed op")
    return d


def phase_analysis(torch, bert_program):
    """Phase 26: the static verifier on the full-width programs (A), BERT-base
    under the gate (B), a budget it cannot meet (C), and PT060 over phase 25
    B's attribution of ``bert_program`` (D; skipped when None)."""
    import paddle_tpu_torch as pt
    t0 = time.perf_counter()
    bert, programs = _analysis_programs(pt)
    a = _analysis_verify_zoo(pt, programs)
    del programs
    b, c = _analysis_gate(torch, pt, bert)
    del bert
    torch.cuda.empty_cache()
    d = _analysis_layout_churn(bert_program) if bert_program is not None else None
    r = dict(a=a, b=b, c=c, d=d, seconds=time.perf_counter() - t0)
    emit("analysis", seconds=r["seconds"])
    return r

# ---------------------------------------------------------------------------------------
# phase 27: the warm store (a BERT-base replica restarted cold and warm) and the helpers
# ---------------------------------------------------------------------------------------

#: the pool's pow2 buckets (max_batch 8) and phase 4's first request's sequence length
WARM_BUCKETS = (1, 2, 4, 8)
WARM_SEQ = BERT_REQUESTS[0][1]
#: nets.scaled_dot_product_attention at BERT-base's width, f32 (K1-fwd's f32 kernel
#: against the program's plain route, the composed attention: ATOL["float32"])
NETS_ATTN = dict(batch=8, seq=512, width=768, heads=12)


def _checkout_copy(dest):
    """The package and this script, copied without any build (``csrc/build``,
    ``native/build``): what a fresh checkout holds."""
    ignore = shutil.ignore_patterns("build", "__pycache__", "*.pyc")
    shutil.copytree(os.path.join(REPO, "paddle_tpu_torch"),
                    os.path.join(dest, "paddle_tpu_torch"), ignore=ignore)
    shutil.copy2(os.path.join(REPO, "chip_smoke.py"), dest)
    return dest


def warm_start_child(model_dir, out_dir) -> int:
    """One serving replica's start, timed by part (run as ``chip_smoke.py
    --warm-start-child MODEL_DIR OUT_DIR`` from a fresh copy, with
    ``PADDLE_TPU_WARMSTORE`` set): import, a ``PredictorPool`` over
    phase 4's model (the model load), ``warmup`` over the buckets (the
    store's scan, each bucket's eager first run and capture, the kernels'
    builds or restores), the first answer; then each bucket's output to
    ``OUT_DIR``, and a JSON line."""
    t0 = time.perf_counter()
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import cuda_build
    from paddle_tpu_torch.observability.metrics import REGISTRY
    from paddle_tpu_torch.ops import flash_attention
    from paddle_tpu_torch.serving import PredictorPool
    from paddle_tpu_torch.tools.serving_profile import bert_feed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.init()
    import_s = time.perf_counter() - t0
    t = time.perf_counter()
    pool = PredictorPool(model_dir, size=1, max_batch=max(WARM_BUCKETS), max_wait_ms=2.0)
    load_s = time.perf_counter() - t
    pred = pool._predictors[0]
    feed = bert_feed(np.random.RandomState(SEED + 27), 1, WARM_SEQ,
                     pt.models.bert.BertConfig().vocab_size)
    t = time.perf_counter()
    warmed = pool.warmup(feed)
    warmup_s = time.perf_counter() - t
    t = time.perf_counter()
    first = pool.run(feed)[0]
    first_s = time.perf_counter() - t
    ttfa_s = time.perf_counter() - t0
    buckets = []
    k1 = (flash_attention.flash_attn_fwd, flash_attention.flash_attn_fwd_q64)
    for sig, exe in pred._compiled.items():
        b = int(sig[1][1][0])
        f = {k: np.repeat(v[:1], b, axis=0) for k, v in feed.items()}
        out = pred.run(f, dtype=sig[0])[0]
        np.save(os.path.join(out_dir, f"b{b}.npy"), out)
        if b == 1:
            np.save(os.path.join(out_dir, "first.npy"), first)
        buckets.append(dict(batch=b, warm_up_s=exe.warm_up_s, capture_s=exe.capture_s,
                            k1_launches_per_replay=sum(exe.launches.get(w, 0) for w in k1),
                            graph_pool_bytes=exe.memory_bytes))
    pool.close(drain_timeout=10.0)
    from paddle_tpu_torch import warmstore
    from paddle_tpu_torch.warmstore import probe
    t = time.perf_counter()
    flushed = warmstore.flush(300.0)
    flush_s = time.perf_counter() - t
    store = warmstore.active_store()
    v = probe.verdict(cache_dir=store.probe_dir)

    def counter(name):
        fam = REGISTRY.get(name)
        return {} if fam is None else {",".join(f"{k}={x}" for k, x in lbl) or "all": c.value
                                       for lbl, c in fam.items()}
    print(json.dumps({"warm_start_child": dict(
        total_s=time.perf_counter() - t0, import_s=import_s, model_load_s=load_s, warmup_s=warmup_s, first_answer_s=first_s,
        time_to_first_answer_s=ttfa_s, flush_s=flush_s, flushed=flushed, warmed=warmed,
        nvcc=cuda_build.stats["nvcc"], nvcc_s=cuda_build.stats["nvcc_s"],
        restored=cuda_build.stats["restored"], restore_s=cuda_build.stats["restore_s"],
        buckets=sorted(buckets, key=lambda r: r["batch"]),
        captures=sum(1 for e in pred._compiled.values() if hasattr(e, "capture_s")),
        verdict=dict(tier_a=v.tier_a, source=v.source, reason=v.reason),
        hits=counter("warmstore_hits_total"), misses=counter("warmstore_misses_total"),
        quarantined=counter("warmstore_quarantined_total"), kernels=sorted(cuda_build._loaded),
        probes_spawned=probe.SPAWNS)}), flush=True)
    return 0


class WarmChild:
    """A serving replica started in a child process from a fresh copy of the
    checkout with the store at ``store`` armed (``warm_start_child``);
    ``result()`` waits for it and returns (its report, outputs, wall
    seconds). Its failure fails the phase; a child still running when this
    script exits is killed."""

    def __init__(self, label, model_dir, store, workdir):
        self.label = label
        copy = _checkout_copy(os.path.join(workdir, f"checkout_{label}"))
        self.out_dir = os.path.join(workdir, f"out_{label}")
        os.makedirs(self.out_dir)
        # the tuner off: the children key the same steps whatever the phases
        # between them decided
        env = dict(os.environ, PADDLE_TPU_WARMSTORE=store, PADDLE_TPU_TUNE="off")
        env.pop("PADDLE_TPU_WARMSTORE_PROBE", None)
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(copy, "chip_smoke.py"), "--warm-start-child",
             model_dir, self.out_dir], cwd=copy, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        atexit.register(self._kill)

    def _kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def result(self):
        stdout, stderr = self.proc.communicate(timeout=600)
        if self.proc.returncode != 0:
            raise SystemExit(f"warm-start child {self.label} exited {self.proc.returncode}:\n"
                             f"{stdout[-4000:]}\n{stderr[-4000:]}")
        report = next(json.loads(ln)["warm_start_child"] for ln in stdout.splitlines()
                      if ln.startswith('{"warm_start_child"'))
        outs = {b: np.load(os.path.join(self.out_dir, f"b{b}.npy")) for b in WARM_BUCKETS}
        outs["first"] = np.load(os.path.join(self.out_dir, "first.npy"))
        emit("warm_start_child", child=self.label, **report)
        return report, outs


def start_cold_child(model_dir):
    """Phase 27's cold start, begun right after phase 4 saves its model: an
    empty store under ``build/``, the child run beside phases 7 on (its
    ``nvcc`` is host work; its captures share the card with them)."""
    workdir = tempfile.mkdtemp(prefix="warm_start_", dir=os.path.join(REPO, "build"))
    atexit.register(shutil.rmtree, workdir, ignore_errors=True)
    store = os.path.join(workdir, "store")
    return dict(workdir=workdir, store=store, model_dir=model_dir,
                child=WarmChild("cold", model_dir, store, workdir))


def start_fault_child(run):
    """After phase 11: the cold child's result and its store's ``verify``;
    then a copy of that store with each stored library corrupted by
    ``faults.mutate_warmstore``, and the third child started on the copy,
    beside phases 13 on (its ``nvcc`` is host work). Phase 27's warm child
    reads the intact store."""
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.warmstore.store import WarmStore
    run["cold"] = run.pop("child").result()
    run["verify_cold"] = _store_verify(run["store"])
    bad = os.path.join(run["workdir"], "store_corrupted_library")
    shutil.copytree(run["store"], bad)
    run["libs"] = [r for r in WarmStore(bad).ls() if r["kind"] == "library"]
    faults.install("corrupt@warmstore_write")
    run["mutated"] = [a for r in run["libs"] for a in faults.mutate_warmstore(
        os.path.join(bad, "entries", r["digest"]))]
    faults.clear()
    run["store_fault"] = bad
    run["fault_child"] = WarmChild("corrupted_library", run["model_dir"], bad, run["workdir"])
    return run


def _store_verify(store):
    """``python -m paddle_tpu_torch.warmstore --root STORE verify``, in this
    process: (exit code, printed lines)."""
    import contextlib
    import io
    from paddle_tpu_torch.warmstore.__main__ import main as ws_cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ws_cli(["--root", store, "verify"])
    return rc, buf.getvalue().strip().splitlines()


def _warm_restart(torch, pt, run, helpers):
    """A: the cold child (``start_cold_child``), the warm child alone on the
    card over the store the cold one wrote, and the third child over a copy
    with its library corrupted (``start_fault_child``), collected while this
    process computes its reference and runs ``helpers`` (B); every bucket's
    output byte-equal across the children and this process's Predictor."""
    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.tools.serving_profile import bert_feed
    from paddle_tpu_torch.warmstore.store import WarmStore
    store, model_dir = run["store"], run["model_dir"]
    cold, cold_out = run["cold"]
    rc_cold, verify_cold = run["verify_cold"]
    warm, warm_out = WarmChild("warm", model_dir, store, run["workdir"]).result()
    rc_warm, verify_warm = _store_verify(store)
    # this process's Predictor on the same feeds, its tuner off as the children's
    feed = bert_feed(np.random.RandomState(SEED + 27), 1, WARM_SEQ,
                     pt.models.bert.BertConfig().vocab_size)
    tune = os.environ.get("PADDLE_TPU_TUNE")
    os.environ["PADDLE_TPU_TUNE"] = "off"
    try:
        pred = Predictor(model_dir)
        ref = {b: pred.run({k: np.repeat(v[:1], b, axis=0) for k, v in feed.items()})[0]
               for b in WARM_BUCKETS}
    finally:
        if tune is None:
            os.environ.pop("PADDLE_TPU_TUNE")
        else:
            os.environ["PADDLE_TPU_TUNE"] = tune
    del pred
    torch.cuda.empty_cache()
    b_result = helpers()
    fault, fault_out = run["fault_child"].result()
    rc_fault, verify_fault = _store_verify(run["store_fault"])
    children = (("cold", cold_out), ("warm", warm_out), ("corrupted_library", fault_out))
    byte_equal = {label: {str(b): bool(np.array_equal(outs[b], ref[b])) for b in WARM_BUCKETS}
                  for label, outs in children}
    first_equal = {label: bool(np.array_equal(outs["first"], ref[1])) for label, outs in children}
    n_kernels = len(cold["kernels"])
    checks = {
        "cold_built_its_kernels_with_nvcc": cold["nvcc"] == n_kernels >= 1,
        "cold_store_verifies": rc_cold == 0,
        "warm_ran_no_nvcc": warm["nvcc"] == 0,
        "warm_tier_a_hit_per_kernel": warm["restored"] == n_kernels
        and warm["hits"].get("tier=a", 0) == n_kernels,
        "warm_tier_b_hit_per_bucket": warm["hits"].get("tier=b", 0) == len(WARM_BUCKETS)
        and not warm["misses"],
        "warm_verdict_passes": warm["verdict"]["tier_a"],
        "warm_store_verifies": rc_warm == 0,
        "every_bucket_captured": cold["captures"] == warm["captures"] == fault["captures"]
        == len(WARM_BUCKETS),
        "k1_fwd_12_a_replay": all(r["k1_launches_per_replay"] == 12
                                  for c in (cold, warm, fault) for r in c["buckets"]),
        "outputs_byte_equal": all(all(v.values()) for v in byte_equal.values())
        and all(first_equal.values()),
        "library_corrupted": len(run["mutated"]) == len(run["libs"]) == n_kernels,
        "corrupted_library_quarantined": fault["quarantined"].get("all", 0) >= 1
        and any(ln.endswith("quarantined") for ln in verify_fault),
        "corrupted_library_rebuilt_by_nvcc": fault["nvcc"] == n_kernels
        and fault["restored"] == 0,
    }
    r = dict(cold=cold, warm=warm, corrupted_library=fault, byte_equal=byte_equal,
             first_answer_equal=first_equal, mutated=run["mutated"],
             verify=dict(cold=[rc_cold, verify_cold[-1:]], warm=[rc_warm, verify_warm[-1:]],
                         corrupted_library=[rc_fault, verify_fault]),
             store=WarmStore(store).ls(), checks=checks)
    emit("warm_restart", **{k: v for k, v in r.items() if k not in ("cold", "warm",
                                                                   "corrupted_library")})
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise SystemExit(f"phase 27 A failed {bad}")
    return r, b_result


def _helpers_on_card(torch, pt):
    """B: ``install_check.run_check()`` on the card (the ``sgd`` kind of
    ``multi_tensor_update``), and ``nets.scaled_dot_product_attention`` at
    BERT-base's width against its plain route on the card, K1-fwd counted."""
    from paddle_tpu_torch.ops import flash_attention, multi_tensor
    mt0 = multi_tensor.multi_tensor_update.launches
    pt.install_check.run_check()
    install_launches = multi_tensor.multi_tensor_update.launches - mt0
    c = NETS_ATTN
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = SEED
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.data("x", [c["seq"], c["width"]], "float32")
        out = pt.nets.scaled_dot_product_attention(x, x, x, num_heads=c["heads"])
    feed = {"x": np.random.RandomState(SEED + 28).randn(
        c["batch"], c["seq"], c["width"]).astype("float32")}
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt.Executor().run(startup)
        k1 = (flash_attention.flash_attn_fwd, flash_attention.flash_attn_fwd_q64)
        before = [w.launches for w in k1]
        got, = pt.Executor().run(main, feed=feed, fetch_list=[out])
        k1_launches = sum(w.launches - n for w, n in zip(k1, before))
        for op in main.global_block().ops:
            if op.type == "fused_attention":
                op.attrs["impl"] = "composed"
        plain, = pt.Executor().run(main, feed=feed, fetch_list=[out])
    err = float(np.abs(got - plain).max())
    r = dict(install_check_multi_tensor_update_launches=install_launches,
             attention=dict(**c, dtype="float32", k1_fwd_launches=k1_launches,
                            max_abs_err=err, atol=ATOL["float32"],
                            finite=bool(np.isfinite(got).all()), shape=list(got.shape)))
    emit("helpers_on_card", **r)
    if install_launches < 1:
        raise SystemExit("install_check.run_check() launched no multi_tensor_update")
    if not (k1_launches == 1 and err <= ATOL["float32"] and r["attention"]["finite"]
            and list(got.shape) == [c["batch"], c["seq"], c["width"]]):
        raise SystemExit(f"nets.scaled_dot_product_attention on the card: {r['attention']}")
    return r


def phase_warm_start(torch, run):
    """Phase 27: phase 4's BERT-base restarted cold and warm through the warm
    store, and from a store with a corrupted library (A; ``run`` from
    ``start_cold_child`` and ``start_fault_child``), and the fluid helpers
    on the card (B)."""
    import paddle_tpu_torch as pt
    t0 = time.perf_counter()
    try:
        a, b = _warm_restart(torch, pt, run, lambda: _helpers_on_card(torch, pt))
    finally:
        shutil.rmtree(run["workdir"], ignore_errors=True)
    r = dict(a=a, b=b, seconds=time.perf_counter() - t0)
    emit("warm_start", seconds=r["seconds"])
    return r


CAPI_HW, CAPI_BATCHES, CAPI_RUNS = 224, (1, 128), 20
CAPI_DTYPES = ("float32", "bfloat16")
CAPI_THREADS, CAPI_THREAD_CALLS = 4, 3
#: ABI calls per dtype and batch in A's observed window (journal and profiler armed)
CAPI_OBS_CALLS = 2
#: B's spec: the chaos CLI docstring's
CHAOS_SPEC = "nan:step=3:var=LOSS;exc@dispatch:step=5;preempt:step=7"


def _capi_models(torch, pt, workdir):
    """ResNet-50 (``is_test``, 1000 classes) at 3 x CAPI_HW x CAPI_HW, saved
    twice from one set of weights (the f32 startup's draw rounded to bf16, as
    phase 16's VGG-16): in f32, and in bf16 behind a cast of the f32 image, so
    that both take the float32 tensors of the C ABI's contract. The bf16 copy
    stands for the reference's fp16 row. dtype -> model dir."""
    from paddle_tpu_torch.models import resnet
    progs = {}
    for dtype in CAPI_DTYPES:
        main, startup = pt.Program(), pt.Program()
        main.random_seed = startup.random_seed = SEED
        with pt.unique_name.guard(), pt.program_guard(main, startup):
            img = pt.data("img", [3, CAPI_HW, CAPI_HW], "float32")
            x = img if dtype == "float32" else pt.layers.cast(img, dtype)
            progs[dtype] = (main, startup, resnet.resnet50(x, None, is_test=True))
    shared = {n: t.to(torch.bfloat16)
              for n, t in _startup_state(pt, *progs["float32"][:2]).items()}
    dirs = {}
    for dtype, (main, startup, logits) in progs.items():
        exe, scope = pt.Executor(), pt.Scope()
        with pt.scope_guard(scope):
            exe.run(startup)
            names = {n for n, v in main.global_block().vars.items() if v.persistable}
            if names != set(shared):
                raise SystemExit(f"resnet50 {dtype}: parameters {sorted(names ^ set(shared))} "
                                 f"are not in both builds")
            for n, t in shared.items():
                scope.set_var(n, t.to(scope.find_var(n).dtype))
            dirs[dtype] = os.path.join(workdir, f"resnet50_{dtype}")
            pt.io.save_inference_model(dirs[dtype], ["img"], [logits], exe, main_program=main)
        exe.close()
    return dirs


def _median_call_ms(fn, runs=CAPI_RUNS):
    """The first call (a new signature's capture), then the median ms of
    ``runs`` calls, and the last output. Both paths return host arrays, so
    each call's time ends after its device work."""
    out = fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def _predictor_misses() -> float:
    """``predictor_executable_cache_total{outcome=miss}``: on the card, the
    graphs every Predictor of this process captured."""
    from paddle_tpu_torch.observability.metrics import REGISTRY
    fam = REGISTRY.get("predictor_executable_cache_total")
    c = fam.children.get((("outcome", "miss"),)) if fam is not None else None
    return c.value if c is not None else 0.0


def _capi_threads(lib, handle, singles, dtype):
    """CAPI_THREADS threads call ``pd_predictor_run`` together, each on its own
    mb-1 image CAPI_THREAD_CALLS times; each must get its solo run's bytes."""
    import threading

    from paddle_tpu_torch.native import capi

    def call(x):
        out = np.empty(1000, np.float32)
        rc, _ = capi.run(lib, handle, {"img": x}, out)
        return rc, out.tobytes()

    solo = [call(x) for x in singles]
    got = [None] * len(singles)
    go = threading.Barrier(len(singles))

    def client(i):
        go.wait()
        got[i] = [call(singles[i]) for _ in range(CAPI_THREAD_CALLS)]

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(singles))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return dict(dtype=dtype, threads=len(singles), calls_each=CAPI_THREAD_CALLS,
                solo_rc=[rc for rc, _ in solo],
                bytes_equal_to_solo=all(g == [solo[i]] * CAPI_THREAD_CALLS
                                        for i, g in enumerate(got)))


def _capi_observed(pt, lib, handles, images, workdir):
    """A's observed window: CAPI_OBS_CALLS ABI calls per dtype and batch (all
    captured already) with the journal armed, inside a ``fluid.profiler``
    session; then the metrics dump and the session's trace with the
    Predictor's spans. Paths, and the ABI calls made."""
    from paddle_tpu_torch.native import capi
    from paddle_tpu_torch.observability import export
    obs = dict(journal=os.path.join(workdir, "journal.jsonl"),
               metrics=os.path.join(workdir, "metrics.json"),
               trace_dir=os.path.join(workdir, "profile"),
               trace=os.path.join(workdir, "timeline.json"), abi_calls=0)
    os.environ.update(PADDLE_TPU_OBS="1", PADDLE_TPU_OBS_JOURNAL=obs["journal"])
    try:
        with pt.profiler.profiler("All", "total", os.path.join(workdir, "summary.txt"),
                                  trace_dir=obs["trace_dir"]):
            for dtype, h in handles.items():
                for batch in CAPI_BATCHES:
                    out = np.empty(batch * 1000, np.float32)
                    for _ in range(CAPI_OBS_CALLS):
                        rc, _ = capi.run(lib, h, {"img": images[batch]}, out)
                        if rc != 0:
                            raise SystemExit(f"phase 28 A: observed {dtype} mb{batch}: rc {rc}: "
                                             f"{lib.pd_last_error()!r}")
                        obs["abi_calls"] += 1
    finally:
        for k in ("PADDLE_TPU_OBS", "PADDLE_TPU_OBS_JOURNAL"):
            os.environ.pop(k, None)
    export.dump_json(obs["metrics"])
    pt.profiler.export_chrome_tracing(obs["trace_dir"], obs["trace"])
    return obs


def _capi_serve(torch, pt, workdir):
    """A: ResNet-50 in f32 and bf16 served through ``pd_predictor_create`` on
    the card (ctypes) and through the Python ``Predictor`` on the same host
    images, at each batch of CAPI_BATCHES: the median latency of CAPI_RUNS calls
    after the first, the graphs each captured, the program's FLOPs
    (``utils/flops.py``) and their share of the card's peak, the ABI's output
    byte-equal to the Predictor's; a short buffer (-2), CAPI_THREADS threads
    against their solo runs, a bad model directory (NULL and a message); then
    the observed window for C."""
    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.native import capi
    from paddle_tpu_torch.utils import flops
    t0 = time.perf_counter()
    lib = capi.load()
    build_s = time.perf_counter() - t0
    dirs = _capi_models(torch, pt, workdir)
    rng = np.random.RandomState(SEED + 28)
    images = {b: rng.rand(b, 3, CAPI_HW, CAPI_HW).astype("float32") for b in CAPI_BATCHES}
    singles = [rng.rand(1, 3, CAPI_HW, CAPI_HW).astype("float32")
               for _ in range(CAPI_THREADS)]
    kind = torch.cuda.get_device_name(0)
    repo = REPO.encode()
    bad = lib.pd_predictor_create(os.path.join(workdir, "no_model").encode(), repo)
    refusal = dict(handle_null=not bad, message=lib.pd_last_error().decode(errors="replace")[:300])
    rows, threads, handles = [], [], {}
    for dtype, model_dir in dirs.items():
        h = lib.pd_predictor_create(model_dir.encode(), repo)
        if not h:
            raise SystemExit(f"phase 28 A: pd_predictor_create({dtype}) returned NULL: "
                             f"{lib.pd_last_error()!r}")
        handles[dtype] = h
        pred = Predictor(model_dir)
        for batch in CAPI_BATCHES:
            out = np.empty(batch * 1000, np.float32)

            def abi(b=batch, o=out):
                rc, shape = capi.run(lib, h, {"img": images[b]}, o)
                if rc != 0 or shape != (b, 1000):
                    raise SystemExit(f"phase 28 A: pd_predictor_run {dtype} mb{b}: rc {rc}, "
                                     f"shape {shape}: {lib.pd_last_error()!r}")
                return o.reshape(shape).copy()

            m0 = _predictor_misses()
            abi_ms, abi_out = _median_call_ms(abi)
            abi_graphs = _predictor_misses() - m0
            n0 = len(pred._compiled)
            py_ms, py_out = _median_call_ms(lambda b=batch: pred.run({"img": images[b]})[0])
            # where the time goes: the same requests from a tensor already on
            # the card (the same signature, so the same graph), and the copy
            # of the host images to the card alone
            card = torch.from_numpy(images[batch]).to("cuda")
            card_ms, card_out = _median_call_ms(lambda c=card: pred.run({"img": c})[0])
            h2d_ms, _ = _median_call_ms(
                lambda b=batch: (torch.from_numpy(images[b]).to("cuda"), torch.cuda.synchronize()))
            del card
            short_rc, _ = capi.run(lib, h, {"img": images[batch]},
                                   np.empty(batch * 1000 - 1, np.float32))
            f = flops.program_flops(pred.program, batch)["total"]
            pdt = flops.product_dtype(pred.program, batch)
            peak = flops.device_peak_flops(kind, pdt)
            row = dict(dtype=dtype, batch=batch,
                       ms={"abi": abi_ms, "python": py_ms, "python_card_feed": card_ms},
                       h2d_ms=h2d_ms,
                       images_per_s={"abi": batch / abi_ms * 1e3,
                                     "python": batch / py_ms * 1e3},
                       graphs_captured={"abi": int(abi_graphs),
                                        "python": len(pred._compiled) - n0},
                       flops=f, product_dtype=pdt, peak_flops=peak,
                       flops_share={"abi": f / (abi_ms / 1e3) / peak if peak else None,
                                    "python": f / (py_ms / 1e3) / peak if peak else None},
                       byte_equal_to_python=abi_out.tobytes() == np.ascontiguousarray(
                           py_out, np.float32).tobytes(),
                       card_feed_byte_equal=bool(np.array_equal(card_out, py_out)),
                       finite=bool(np.isfinite(abi_out).all()), shape=list(abi_out.shape),
                       max_abs_logit=float(np.abs(abi_out).max()), short_buffer_rc=short_rc,
                       num_outputs=lib.pd_predictor_num_outputs(h))
            emit("capi_serving", **row)
            rows.append(row)
        threads.append(_capi_threads(lib, h, singles, dtype))
        emit("capi_threads", **threads[-1])
        del pred
        gc.collect()
        torch.cuda.empty_cache()
    observed = _capi_observed(pt, lib, handles, images, workdir)
    for h in handles.values():
        lib.pd_predictor_destroy(h)
    gc.collect()
    torch.cuda.empty_cache()
    a = dict(rows=rows, threads=threads, refusal=refusal, build_s=build_s,
             observed=observed, seconds=time.perf_counter() - t0)
    emit("capi_refusal", **refusal, build_s=build_s, observed_abi_calls=observed["abi_calls"])
    for row in rows:
        if not (row["byte_equal_to_python"] and row["card_feed_byte_equal"] and row["finite"]
                and row["shape"] == [row["batch"], 1000] and row["short_buffer_rc"] == -2
                and row["num_outputs"] == 1
                and row["graphs_captured"] == {"abi": 1, "python": 1}):
            raise SystemExit(f"phase 28 A: {row}")
    for t in threads:
        if not (t["bytes_equal_to_solo"] and t["solo_rc"] == [0] * CAPI_THREADS):
            raise SystemExit(f"phase 28 A: threads {t}")
    if not (refusal["handle_null"] and "Predictor(model_dir)" in refusal["message"]):
        raise SystemExit(f"phase 28 A: a bad model_dir: {refusal}")
    return a


def _kill_child(proc):
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def start_chaos(workdir):
    """B: ``python -m paddle_tpu_torch.resilience --format json`` on the card
    with CHAOS_SPEC and ``--ckpt``, and again with ``--stream``, each with
    the black box armed, as two processes (``main`` starts them before
    phase 26, so that they run beside phases 26 and 27). mode -> (process,
    dir)."""
    procs = {}
    for mode, extra in (("steps", ["--faults", CHAOS_SPEC]), ("stream", ["--stream"])):
        d = os.path.join(workdir, f"chaos_{mode}")
        os.makedirs(d)
        env = dict(os.environ, PADDLE_TPU_OBS_BLACKBOX=os.path.join(d, "postmortems"))
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.resilience", "--format", "json",
             "--ckpt", os.path.join(d, "ck"), *extra],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        atexit.register(_kill_child, proc)
        procs[mode] = (proc, d)
    return procs


def _chaos_results(procs):
    """B's summaries: each run exits 0, each injected fault recovered, the
    preemption resumed, every step completed (the stream run byte-identical
    to its clean reference)."""
    out = {}
    for mode, (proc, d) in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"phase 28 B: the chaos CLI ({mode}) exited {proc.returncode}:\n"
                             f"{stdout[-3000:]}\n{stderr[-3000:]}")
        s = json.loads(stdout)
        out[mode] = dict(summary=s, dir=d)
    s, t = out["steps"]["summary"], out["stream"]["summary"]
    steps = dict(steps=s["steps"], steps_completed=s["steps_completed"], events=s["events"],
                 preempted=s["preempted"], resumed=s["resumed"],
                 resume_start_step=s.get("resume_start_step"), final_loss=s["final_loss"])
    stream = {k: t.get(k) for k in ("steps", "steps_completed", "preempted", "resumed",
                                    "resume_start_step", "byte_identical", "poison_lines",
                                    "dead_letters_attributed", "metrics_live", "events", "ok")}
    emit("chaos_cli", steps=steps, stream=stream)
    ev = s["events"]
    if not (s["steps_completed"] == s["steps"] and ev["fault"] >= 3 and ev["retry"] >= 1
            and ev["skip"] == 1 and ev["preempt"] == 1 and s["resumed"]
            and (s["preempted"] or {}).get("saved_step") is not None
            and s["final_loss"] is not None and np.isfinite(s["final_loss"])):
        raise SystemExit(f"phase 28 B: the chaos run did not recover: {steps}")
    if not (t["ok"] and t["byte_identical"] and t["preempted"] and t["resumed"]
            and t["steps_completed"] == t["steps"]):
        raise SystemExit(f"phase 28 B: the stream chaos run did not recover: {stream}")
    return dict(steps=steps, stream=stream, dirs={m: r["dir"] for m, r in out.items()})


def _tool(main, argv):
    """One operator CLI's ``main(argv)`` in this process, as
    ``python -m <module> argv`` runs it: (exit code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
    return rc, out.getvalue(), err.getvalue()


def _operator_tools(observed, chaos, workdir):
    """C: the operator CLIs over A's and B's artifacts, each through its
    ``main`` in this process: ``obs_report`` over A's journal, metrics dump
    and trace (its predictor request count equal to the ABI calls of A's
    observed window); ``postmortem`` over the bundle of B's preemption (the
    injected faults ranked first); ``ckpt_doctor verify`` over both runs'
    checkpoint trees, and ``fuzz`` over a copy of the stream run's (every
    case run and detected); ``timeline`` over A's trace directory (a valid
    trace)."""
    from paddle_tpu_torch.observability import timeline
    from paddle_tpu_torch.tools import ckpt_doctor, obs_report, postmortem
    from paddle_tpu_torch.tools import timeline as timeline_cli
    steps_dir, stream_dir = chaos["dirs"]["steps"], chaos["dirs"]["stream"]
    pm_dir = os.path.join(steps_dir, "postmortems")
    bundles = sorted(os.listdir(pm_dir)) if os.path.isdir(pm_dir) else []
    if not bundles:
        raise SystemExit("phase 28 C: B's chaos run wrote no post-mortem bundle")
    stream_tree = os.path.join(stream_dir, "ck", "ck")     # --stream's --ckpt is its work dir
    fuzzed = os.path.join(workdir, "fuzzed_tree")
    shutil.copytree(stream_tree, fuzzed)
    tl_out = os.path.join(workdir, "timeline_cli.json")
    t0 = time.perf_counter()
    res = {
        "obs_report": _tool(obs_report.main, [
            "--journal", observed["journal"], "--metrics", observed["metrics"],
            "--trace", observed["trace"], "--goodput"]),
        "postmortem": _tool(postmortem.main, [os.path.join(pm_dir, bundles[0]),
                                              "--format", "json"]),
        "verify_steps": _tool(ckpt_doctor.main, ["verify", os.path.join(steps_dir, "ck"),
                                                 "--format", "json"]),
        "verify_stream": _tool(ckpt_doctor.main, ["verify", stream_tree, "--format", "json"]),
        "fuzz": _tool(ckpt_doctor.main, ["fuzz", fuzzed, "--format", "json"]),
        "timeline": _tool(timeline_cli.main, ["--trace_dir", observed["trace_dir"],
                                              "--timeline_path", tl_out])}
    seconds = time.perf_counter() - t0
    rc = {k: r[0] for k, r in res.items()}
    report = res["obs_report"][1]
    m = re.search(r"(\d+) predictor requests", report)
    requests = int(m.group(1)) if m else None
    pm = json.loads(res["postmortem"][1]) if rc["postmortem"] == 0 else {}
    causes = [c["cause"] for c in pm.get("probable_causes", [])]
    fuzz = json.loads(res["fuzz"][1]) if res["fuzz"][1].strip() else {}
    verify = {k: json.loads(res[k][1]) for k in ("verify_steps", "verify_stream")
              if res[k][1].strip()}
    trace_events = len(timeline.validate_trace(tl_out)) if rc["timeline"] == 0 else 0
    c = dict(rc=rc, predictor_requests=requests, abi_calls=observed["abi_calls"],
             report_sections=re.findall(r"^== (.+) ==$", report, flags=re.M),
             postmortem_reason=pm.get("reason"), postmortem_causes=causes[:3],
             verify_latest_step={k: v.get("latest_complete_step") for k, v in verify.items()},
             fuzz_cases={x["case"]: (x.get("ok"), bool(x.get("skipped")))
                         for x in fuzz.get("cases", [])},
             timeline_trace_events=trace_events, seconds=seconds)
    emit("operator_tools", **c)
    if any(rc.values()):
        bad = {k: (r[0], r[2][-1500:]) for k, r in res.items() if r[0]}
        raise SystemExit(f"phase 28 C: a tool failed: {bad}")
    if requests != observed["abi_calls"] or "Timeline" not in c["report_sections"]:
        raise SystemExit(f"phase 28 C: obs_report counts {requests} predictor requests, A made "
                         f"{observed['abi_calls']} ABI calls: {c}")
    if not (causes and causes[0].startswith("injected fault(s)") and "exc@dispatch" in causes[0]
            and "nan@fetch" in causes[0]):
        raise SystemExit(f"phase 28 C: postmortem does not name the injected cause: {c}")
    if not (fuzz.get("ok") and len(c["fuzz_cases"]) == 4
            and all(ok and not skipped for ok, skipped in c["fuzz_cases"].values())):
        raise SystemExit(f"phase 28 C: ckpt_doctor fuzz: {c}")
    return c


def phase_serving_capi(torch, workdir, chaos=None):
    """Phase 28: ResNet-50 served through the C ABI (A), the chaos CLI on the
    card (B: ``chaos`` from ``start_chaos``, else started here, beside A) and
    the operator tools over A's and B's artifacts (C)."""
    import paddle_tpu_torch as pt
    t0 = time.perf_counter()
    chaos = chaos or start_chaos(workdir)
    a = _capi_serve(torch, pt, workdir)
    b = _chaos_results(chaos)
    c = _operator_tools(a["observed"], b, workdir)
    r = dict(a=a, b=b, c=c, seconds=time.perf_counter() - t0)
    emit("serving_capi", seconds=r["seconds"])
    return r


# -- phase 29: dygraph --------------------------------------------------------------------

# BERT-base trained eagerly through the dygraph tape (B): batch x seq tokens in f32,
# Adam at this rate; three steps at dropout 0 against the static program, then five
# with dropout 0.1
DY_BATCH, DY_SEQ, DY_LR = 32, 128, 1e-4
DY_STATIC_STEPS, DY_DROPOUT_STEPS = 3, 5
# the eager losses against the static program's from the same weights: both run the
# same kernels and cuBLAS products in f32 (TF32 off), the tape's generic grad ops
# differentiate kept graphs as the executor's do, and the updates are the adam
# lowering against multi_tensor_update's (bit for bit in phase 9); what differs is the
# order of a few f32 sums (the grad accumulation of a var read twice), 1e-4 relative
DY_LOSS_RTOL = 1e-4
# traced (C): the traced program at the serving batch and at 1 row, and 8 Predictor
# requests, against the eager output in f32: the same lowerings and kernels, launched
# from the executor's graph instead of the tape (layer-norm outputs of unit scale)
DY_SERVE_BATCH, DY_REQUESTS = 8, 8
DY_TRACED_RTOL = DY_TRACED_ATOL = 1e-5


def _dy_attention(torch, dg, fa):
    """A: one bf16 ``fused_attention`` through the tape at B128 H12 S128 D64,
    dropout 0.1, then ``reduce_sum`` and ``backward()``: O, dQ, dK, dV held
    against the plain versions under the op's own seed (the tape's salt,
    replayed into its grad op)."""
    from paddle_tpu_torch.core.registry import seed_int
    from paddle_tpu_torch.dygraph import base
    B, H, S, D, p = 128, 12, 128, 64, ATTN_DROPOUT
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 29)
    q, k, v, bias = _attn_inputs(torch, B, H, S, D, torch.bfloat16, True, gen)
    Q, K, V = (dg.to_variable(t) for t in (q, k, v))
    bv = dg.to_variable(bias)
    bv.stop_gradient = True
    scale = 1.0 / D ** 0.5
    _zero_launches()
    o = dg.trace_op("fused_attention", {"Q": [Q], "K": [K], "V": [V], "Bias": [bv]},
                    {"scale": scale, "dropout_prob": p}, ["Out"])["Out"][0]
    salt = base._state.tape[-1]["salt"]
    total = dg.trace_op("reduce_sum", {"X": [o]}, {"reduce_all": True}, ["Out"])["Out"][0]
    total.backward()
    torch.cuda.synchronize()
    launches = {"k1_fwd": _k1_launches(), "k1_bwd": fa.flash_attn_bwd.launches}
    seed = seed_int(0, 0, salt)
    err = lambda a, r: (a.float() - r.float()).abs().max().item()
    ref_o = fa.attention_plain(q, k, v, bias, scale, False, p, seed)
    fwd_tol = max(ATOL["bfloat16"], FWD_REL_BF16 * ref_o.float().abs().max().item())
    fwd_err = err(o.value, ref_o)
    ref_g = fa.attention_bwd_plain(q, k, v, bias, o.value, torch.ones_like(o.value), scale,
                                   False, p, seed)
    grads = {n: dict(max_abs_err=err(t.grad, r), max_abs_ref=r.float().abs().max().item())
             for n, t, r in zip(("dq", "dk", "dv"), (Q, K, V), ref_g)}
    # the mask the backward regenerated is the forward's: a wrong salt draws another
    # mask, which moves every gradient by O(1) of its scale
    other = fa.attention_bwd_plain(q, k, v, bias, o.value, torch.ones_like(o.value), scale,
                                   False, p, seed_int(0, 0, salt + 1))
    wrong_salt_err = err(V.grad, other[2])
    ok = (fwd_err <= fwd_tol and launches == {"k1_fwd": 1, "k1_bwd": 1}
          and all(g["max_abs_err"] <= BWD_REL["bfloat16"] * g["max_abs_ref"]
                  for g in grads.values())
          and wrong_salt_err > BWD_REL["bfloat16"] * grads["dv"]["max_abs_ref"])
    r = dict(shape=[B, H, S, D], dtype="bfloat16", dropout=p, salt=salt, seed=seed,
             max_abs_err=fwd_err, atol=fwd_tol, grads=grads, rel_tol=BWD_REL["bfloat16"],
             dv_err_under_another_salt=wrong_salt_err, launches=launches, ok=ok)
    emit("dygraph_attention", **r)
    if not ok:
        raise SystemExit(f"dygraph fused_attention through the tape failed: {r}")
    return r


def _dy_counts(dropout_mod, fa):
    return {"flash_attn_fwd": fa.flash_attn_fwd.launches,
            "flash_attn_fwd_q64": fa.flash_attn_fwd_q64.launches,
            "flash_attn_bwd": fa.flash_attn_bwd.launches,
            "dropout_fwd": dropout_mod.dropout_fwd.launches}


def _dy_static(torch, pt, bert, db, cfg, feed):
    """The static ``models.bert.encoder`` program: its startup weights (on
    the card) and its losses over DY_STATIC_STEPS, captured after the first."""
    main, startup, _, total = db.static_encoder(pt, bert, cfg, DY_BATCH, DY_SEQ, DY_LR)
    exe, scope = pt.Executor(), pt.Scope()
    with pt.scope_guard(scope):
        exe.run(startup)
        init = {p.name: scope.find_var(p.name).clone() for p in main.all_parameters()}
        losses = [float(exe.run(main, feed=feed, fetch_list=[total])[0].reshape(-1)[0])
                  for _ in range(DY_STATIC_STEPS)]
    exe.close()
    return init, losses


def _dy_train(torch, pt, dg, bert, db, fa, dropout_mod):
    """B: BERT-base from dygraph layers, in f32 at dropout 0 against the
    static program from the same weights (3 Adam steps), then 5 steps with
    dropout 0.1: losses, step ms and launches a step."""
    cfg = bert.BertConfig(dropout=0.0)
    feed = db.feed(np.random.RandomState(SEED), cfg, DY_BATCH, DY_SEQ)
    init, static_losses = _dy_static(torch, pt, bert, db, cfg, feed)
    ins = [dg.to_variable(feed[n]) for n, _ in db.FEEDS]

    def model_and_opt(c):
        with pt.unique_name.guard():
            m = db.build_encoder(c)
        db.load_static_state(m, init)
        return m, dg.AdamOptimizer(DY_LR)

    model, opt = model_and_opt(cfg)
    losses = []
    _zero_launches()
    for _ in range(DY_STATIC_STEPS):
        total = db.loss(dg, model(*ins))
        opt.minimize(total, parameter_list=model.parameters())
        losses.append(float(total.numpy().reshape(-1)[0]))
    f32_launches = _dy_counts(dropout_mod, fa)
    del model, opt
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, static_losses)]

    model, opt = model_and_opt(bert.BertConfig(dropout=ATTN_DROPOUT))
    marks, dropped = [], []
    torch.cuda.synchronize()
    _zero_launches()
    # DY_DROPOUT_STEPS timed steps, then one more under the profiler: CUDA events
    # after the forward, the tape's backward and the Adam updates
    for i in range(DY_DROPOUT_STEPS + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        prof = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                   torch.profiler.ProfilerActivity.CUDA])
                if i == DY_DROPOUT_STEPS else contextlib.nullcontext())
        with prof:
            ev[0].record()
            total = db.loss(dg, model(*ins))
            ev[1].record()
            total.backward()
            ev[2].record()
            opt.minimize(total, parameter_list=model.parameters())
            ev[3].record()
            torch.cuda.synchronize()
        marks.append(ev)
        dropped.append(total)
    counts = _dy_counts(dropout_mod, fa)
    busy_ms = _device_busy_ms(prof)
    drop_losses = [float(t.numpy().reshape(-1)[0]) for t in dropped]
    parts = [[ev[j].elapsed_time(ev[j + 1]) for j in range(3)] for ev in marks]
    step_ms = [sum(p) for p in parts[:DY_DROPOUT_STEPS]]
    median_ms = statistics.median(step_ms[1:])
    per_step = {k: v / (DY_DROPOUT_STEPS + 1) for k, v in counts.items()}
    ok = (max(gaps) <= DY_LOSS_RTOL and all(np.isfinite(drop_losses))
          and all(np.isfinite(losses)) and per_step["flash_attn_bwd"] == cfg.n_layers
          and per_step["flash_attn_fwd"] + per_step["flash_attn_fwd_q64"] == cfg.n_layers
          and per_step["dropout_fwd"] == 2 * cfg.n_layers + 1)
    r = dict(batch=DY_BATCH, seq=DY_SEQ, lr=DY_LR, layers=cfg.n_layers,
             static_losses=static_losses,
             eager_losses=losses, loss_rel_gaps=gaps, rtol=DY_LOSS_RTOL,
             f32_dropout0_launches=f32_launches, dropout_losses=drop_losses,
             step_ms=step_ms, step_ms_median_last4=median_ms,
             forward_backward_update_ms=[statistics.median(p[j] for p in parts[1:-1])
                                         for j in range(3)],
             profiled_step_ms=sum(parts[-1]), device_busy_ms=busy_ms,
             idle_share=max(0.0, 1 - busy_ms / median_ms),
             launches=counts, launches_per_step=per_step, ok=ok)
    emit("dygraph_training", **r)
    if not ok:
        raise SystemExit(f"dygraph BERT-base training failed: {r}")
    return r, model, cfg, feed


def _dy_serve(torch, pt, dg, db, fa, dropout_mod, model, cfg, feed, workdir):
    """C: the trained encoder in eval mode traced at DY_SERVE_BATCH, run on
    the executor (captured) at that batch and at 1 row, exported and served
    by the Predictor: each against the eager output."""
    model.eval()
    names = [n for n, _ in db.FEEDS]
    batch = {n: feed[n][:DY_SERVE_BATCH] for n in names}
    one = {n: feed[n][:1] for n in names}
    out, traced = dg.TracedLayer.trace(model, [dg.to_variable(batch[n]) for n in names])
    with dg.no_grad():
        eager1 = model(*[dg.to_variable(one[n]) for n in names]).value
    eager = out.value
    err = lambda a, b: float((torch.as_tensor(a, device="cuda") - b).abs().max())
    close = lambda a, b: bool(torch.allclose(torch.as_tensor(a, device="cuda"), b,
                                             rtol=DY_TRACED_RTOL, atol=DY_TRACED_ATOL))
    _zero_launches()
    runs = [traced([batch[n] for n in names])[0] for _ in range(3)]
    runs1 = [traced([one[n] for n in names])[0] for _ in range(3)]
    torch.cuda.synchronize()
    traced_launches = _dy_counts(dropout_mod, fa)
    d = os.path.join(workdir, "dygraph_bert")
    traced.save_inference_model(d)
    pred = pt.inference.Predictor(d)
    rng = np.random.RandomState(SEED + 1)
    reqs = [db.feed(rng, cfg, DY_SERVE_BATCH, DY_SEQ) for _ in range(DY_REQUESTS)]
    with dg.no_grad():
        want = [model(*[dg.to_variable(f[n]) for n in names]).value for f in reqs]
    torch.cuda.synchronize()
    _zero_launches()
    # the first request runs its signature eagerly and then captures and replays it:
    # the rest replay the graph
    served = [pred.run([f[n] for n in names])[0] for f in reqs[:1]]
    first_k1 = _k1_launches()
    served += [pred.run([f[n] for n in names])[0] for f in reqs[1:]]
    torch.cuda.synchronize()
    serve_launches = _dy_counts(dropout_mod, fa)
    k1_per_request = (_k1_launches() - first_k1) / (DY_REQUESTS - 1)
    n_layers = cfg.n_layers
    ok = (all(close(x, eager) for x in runs) and all(close(x, eager1) for x in runs1)
          and all(close(s, w) for s, w in zip(served, want))
          and all(np.isfinite(s).all() for s in served) and k1_per_request == n_layers
          and traced_launches["flash_attn_bwd"] == 0 and traced_launches["dropout_fwd"] == 0
          and (traced_launches["flash_attn_fwd"] + traced_launches["flash_attn_fwd_q64"])
          == 6 * n_layers)
    r = dict(batch=DY_SERVE_BATCH, ops=len(traced.program.global_block().ops),
             traced_max_abs_err=max(err(x, eager) for x in runs),
             traced_b1_max_abs_err=max(err(x, eager1) for x in runs1),
             predictor_max_abs_err=max(err(s, w) for s, w in zip(served, want)),
             rtol=DY_TRACED_RTOL, atol=DY_TRACED_ATOL,
             traced_launches=traced_launches, serve_launches=serve_launches,
             k1_fwd_first_request=first_k1, k1_fwd_per_request=k1_per_request, ok=ok)
    emit("dygraph_traced_serving", **r)
    if not ok:
        raise SystemExit(f"the traced dygraph encoder disagrees with the eager one: {r}")
    traced._executor().close()
    return r


def _dy_checkpoint(dg, model, workdir):
    """D: save_dygraph then load_dygraph of the trained encoder: every array
    byte for byte, and back into the model's tensors bit for bit."""
    import torch
    sd = model.state_dict()
    path = os.path.join(workdir, "dygraph_ckpt", "encoder")
    t0 = time.perf_counter()
    dg.save_dygraph(sd, path)
    loaded, _ = dg.load_dygraph(path)
    seconds = time.perf_counter() - t0
    before = {n: p.value.clone() for n, p in model.named_parameters()}
    model.set_dict(loaded)
    ok = (sorted(loaded) == sorted(sd)
          and all(loaded[n].dtype == sd[n].dtype and loaded[n].tobytes() == sd[n].tobytes()
                  for n in sd)
          and all(torch.equal(p.value, before[n]) for n, p in model.named_parameters()))
    r = dict(arrays=len(sd), bytes=int(sum(a.nbytes for a in sd.values())),
             seconds=seconds, ok=ok)
    emit("dygraph_checkpoint", **r)
    if not ok:
        raise SystemExit(f"the dygraph checkpoint does not round-trip: {r}")
    return r


def phase_dygraph(torch, workdir):
    """Phase 29: dygraph on the card. A: K1-fwd and K1-bwd launched from the
    tape against their plain versions under the tape's seed; B: BERT-base
    trained eagerly (f32 against the static program, then with dropout);
    C: traced, run captured and served; D: its checkpoint round-tripped."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import dygraph as dg
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import dropout as dropout_mod
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.tools import dygraph_bert as db
    t0 = time.perf_counter()
    with dg.guard():
        a = _dy_attention(torch, dg, fa)
        torch.cuda.empty_cache()
        b, model, cfg, feed = _dy_train(torch, pt, dg, bert, db, fa, dropout_mod)
        c = _dy_serve(torch, pt, dg, db, fa, dropout_mod, model, cfg, feed, workdir)
        d = _dy_checkpoint(dg, model, workdir)
    r = dict(a=a, b=b, c=c, d=d, seconds=time.perf_counter() - t0)
    emit("dygraph", seconds=r["seconds"])
    return r


# -- phase 30: data parallel over torch.distributed --------------------------------------
# BERT-base at bench.py's configuration (L12 H768 A12, B128 S128, Adam(1e-4)).
# A: one rank on NCCL, the plain executor's steps against CompiledProgram's
# from one startup state, bf16 dropout 0.1, bit for bit. B, C, D: two ranks
# sharing the card over gloo (CUDA tensors), each fed its 64 rows of the
# global batch of 128 (mask positions drawn a rank, as a multi-device BERT
# reader writes them: ``pretrain_feed(..., microbatches=2)``). B's f32 losses
# at dropout 0 against one process's B128 step: the two ranks' per-row losses
# are the one process's rows, their mean the same mean; what parts them is
# the order of the sums (each rank's gradient summed over 64 rows, the two
# averaged, against one sum over 128 in cuBLAS's blocking), about 1e-7
# relative a step, carried through Adam's three updates.
DP_STEPS = 3
DP_LOCAL = 64                  # rows a rank of B's global batch of 128
DP_LOSS_RTOL = 1e-5
DP_TIMEOUT = 300               # the process group's timeout and the launch's limit, s
DP_NCCL_PROBE_TIMEOUT = 60
#: torch.distributed's own refusal of a collective on a device or op gloo
#: lacks; C counts any other error of an op as a failure
GLOO_REFUSAL = re.compile(r"unsupported device|does not support|not supported"
                          r"|No backend type associated with device type")
# C: each collective op type at world 2 on CUDA tensors (the rank's input a
# seed of its own), against numpy; a sum of two f32 values is exact
DP_OP_CASES = (("c_allreduce_sum", {}, (4, 6)), ("c_allreduce_avg", {}, (4, 6)),
               ("c_allreduce_max", {}, (4, 6)), ("c_allreduce_min", {}, (4, 6)),
               ("c_allreduce_prod", {}, (4, 6)), ("c_allgather", {}, (2, 3)),
               ("c_reducescatter", {}, (4, 3)), ("c_broadcast", {"root": 1}, (3, 5)),
               ("alltoall", {"split_axis": 1, "concat_axis": 0}, (2, 4)),
               ("collective_permute", {"offset": 1}, (3, 4)),
               ("reshard", {"src_dim": -1, "dst_dim": 0}, (4, 3)),
               ("c_sync_calc_stream", {}, (2, 2)), ("c_sync_comm_stream", {}, (2, 2)))


def _dp_op_input(i, rank, shape):
    return np.random.RandomState(100 * i + rank).uniform(0.5, 1.5, shape).astype("float32")


def _dp_op_expected(t, attrs, xs, r):
    """numpy: rank r's output of op ``t`` over the two ranks' inputs."""
    if t == "c_allreduce_sum":
        return xs[0] + xs[1]
    if t == "c_allreduce_avg":
        return (xs[0] + xs[1]) / 2
    if t in ("c_allreduce_max", "c_allreduce_min", "c_allreduce_prod"):
        return {"c_allreduce_max": np.maximum, "c_allreduce_min": np.minimum,
                "c_allreduce_prod": np.multiply}[t](xs[0], xs[1])
    if t == "c_allgather":
        return np.concatenate(xs, 0)
    if t == "c_reducescatter":
        return np.split(xs[0] + xs[1], 2, axis=0)[r]
    if t == "c_broadcast":
        return xs[attrs["root"]]
    if t == "alltoall":
        return np.concatenate([np.split(xs[j], 2, axis=1)[r] for j in range(2)], 0)
    if t == "collective_permute":
        return xs[1 - r]
    if t == "reshard":
        return np.split(xs[r], 2, axis=0)[r]
    return xs[r]


def _dp_ops(torch, rank):
    """C: each op's lowering on this rank's CUDA tensor over the bound gloo
    group: its output, or the error that refused it."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.ops import collective as coll
    out = {}
    with coll.bind({"dp": coll.world_group("dp")}):
        for i, (t, attrs, shape) in enumerate(DP_OP_CASES):
            x = torch.from_numpy(_dp_op_input(i, rank, shape)).cuda()
            ctx = registry.LowerCtx(dict(attrs, axis_name="dp"), x.device)
            try:
                y = registry.get(t).lower(ctx, {"X": [x]})["Out"][0]
                torch.cuda.synchronize()
                out[t] = {"device": str(y.device), "value": y.cpu().numpy().tolist()}
            except Exception as e:   # recorded and held against the other rank's
                out[t] = {"error": f"{type(e).__name__}: {str(e)[:300]}"}
    return out


def _dp_digest(torch, scope, names) -> str:
    """A fingerprint of the named state tensors' bytes, in order, made on
    the card: each tensor's bytes as int16 words, their sum and their sum
    weighted by position (mod 65521), in int64; sha1 of those sums. Two
    tensors whose bytes differ give other sums unless two differences
    cancel in both sums at once; no host copy of the state."""
    import hashlib
    sums = []
    for n in names:
        t = scope.find_var(n).detach().contiguous().reshape(-1)
        w = t.view(torch.uint8)
        w = (w if w.numel() % 2 else w.view(torch.int16)).to(torch.int64)
        pos = torch.arange(w.numel(), device=w.device, dtype=torch.int64) % 65521 + 1
        sums.append(torch.stack([w.sum(), (w * pos).sum()]))
    return hashlib.sha1(torch.cat(sums).cpu().numpy().tobytes()).hexdigest()


def _dp_feeds(cfg, rank=None):
    """DP_STEPS global batches of 128 drawn a rank's 64 rows at a time, as
    this rank's slices (``rank``) or as the whole batch with the masked
    positions made global (``rank`` None)."""
    from paddle_tpu_torch.parallel import env
    from paddle_tpu_torch.tools.train_profile import (MASKS_PER_SEQ, SEQ, global_mask_pos,
                                                      pretrain_feed)
    out = []
    for i in range(DP_STEPS):
        f = pretrain_feed(np.random.RandomState(SEED + i), cfg, 2 * DP_LOCAL, SEQ,
                          MASKS_PER_SEQ, microbatches=2)
        if rank is None:
            f["mask_pos"] = global_mask_pos(f["mask_pos"], 2, 2 * DP_LOCAL, SEQ)
        else:
            f = {k: env.shard_batch(v, rank, 2) for k, v in f.items()}
        out.append(f)
    return out


def _dp_counts():
    from paddle_tpu_torch.ops import dropout as dropout_mod
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import multi_tensor
    return {"flash_attn_fwd": fa.flash_attn_fwd.launches,
            "flash_attn_fwd_q64": fa.flash_attn_fwd_q64.launches,
            "flash_attn_bwd": fa.flash_attn_bwd.launches,
            "dropout_fwd": dropout_mod.dropout_fwd.launches,
            "multi_tensor_update": multi_tensor.multi_tensor_update.launches}


def _dp_bert_rank(torch, pt, rank, dtype, dropout, reduce=False, ckpt_dir=None):
    """B / D on one rank: DP_STEPS steps of BERT-base at 64 rows through
    ``CompiledProgram.with_data_parallel`` from the startup state: losses,
    each step's parameter digest, launches, step ms, peak memory; D's
    moment bytes held and its Checkpointer round trip."""
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.tools.train_profile import LR, MASKS_PER_SEQ, SEQ, build_pretrain
    cfg = bert.BertConfig(dtype=dtype, dropout=dropout)
    main, startup, total, _ = build_pretrain(cfg, DP_LOCAL, SEQ, MASKS_PER_SEQ, LR, SEED)
    bs = pt.BuildStrategy()
    if reduce:
        bs.reduce_strategy = pt.BuildStrategy.ReduceStrategy.Reduce
    cp = pt.CompiledProgram(main, bs).with_data_parallel(loss_name=total.name)
    drops = [op for op in main.global_block().ops
             if op.type == "dropout" and not op.attr("is_test", False)]
    fetch = [total] + ([drops[0].output("Mask")[0]] if dropout else [])
    params = sorted(p.name for p in main.all_parameters())
    exe, scope = pt.Executor(), pt.Scope()
    feeds = [{k: torch.from_numpy(v).cuda() for k, v in f.items()}
             for f in _dp_feeds(cfg, rank)]
    torch.cuda.reset_peak_memory_stats()
    losses, digests, ms, mixed = [], [], [], []
    with pt.scope_guard(scope):
        exe.run(startup)
        torch.cuda.synchronize()
        _zero_launches()
        for f in feeds:
            t0 = time.perf_counter()
            outs = exe.run(cp, feed=f, fetch_list=fetch, return_numpy=False)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(outs[0].float().reshape(-1)[0]))
            digests.append(_dp_digest(torch, scope, params))
            if dropout:
                # the fetched mask is the ranks' average: a value between 0 and
                # the kept scale marks an element that one rank dropped and the
                # other kept
                m = outs[1].float()
                mixed.append(float(((m > 0) & (m < m.max())).float().mean()))
        counts = _dp_counts()
        moments = [n for n in scope.var_names() if "moment" in n]
        r = dict(rank=rank, dtype=dtype, dropout=dropout, reduce=reduce, losses=losses,
                 param_digests=digests, step_ms=ms, launches=counts,
                 launches_per_step={k: v / DP_STEPS for k, v in counts.items()},
                 mask_mixed_share=mixed,
                 moment_bytes=sum(scope.find_var(n).numel() * scope.find_var(n).element_size()
                                  for n in moments),
                 moment_bytes_declared=sum(
                     int(np.prod(main.global_block().vars[n].shape)) * 4 for n in moments),
                 peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                 captured=any(s.graph is not None for s in exe._cache.values()),
                 refusals=sorted({s.refusal for s in exe._cache.values() if s.refusal}))
        if ckpt_dir is not None:
            from paddle_tpu_torch.utils.checkpointer import Checkpointer
            state = sorted(n for n, v in main.global_block().vars.items()
                           if v.persistable and scope.find_var(n) is not None
                           and not n.endswith("@comm_residual"))
            ck = Checkpointer(exe, cp, ckpt_dir, max_to_keep=2)
            t0 = time.perf_counter()
            ck.save(DP_STEPS)
            saved = _dp_digest(torch, scope, state)
            exe.run(cp, feed=feeds[0], fetch_list=[total])        # the state moves on
            moved = _dp_digest(torch, scope, state)
            step = ck.restore()
            r["checkpoint"] = dict(step=step, saved=saved, moved=moved,
                                   restored=_dp_digest(torch, scope, state),
                                   seconds=time.perf_counter() - t0)
    exe.close()
    del exe, scope
    torch.cuda.empty_cache()
    return r


def dp_child(out_dir, what) -> int:
    """A rank of phase 30 (``chip_smoke.py --dp-child OUT_DIR WHAT``, started
    by the port's launcher): ``gloo`` runs B, D and C over two ranks sharing
    the card; ``nccl_shared`` asks NCCL for two ranks on one card and
    records its refusal."""
    import datetime
    import torch
    import torch.distributed as dist
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import env
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = env.get_rank()
    path = os.path.join(out_dir, f"{what}_rank{rank}.json")
    if what == "nccl_shared":
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"tcp://{os.environ['COORDINATOR_ADDRESS']}",
                                world_size=env.get_world_size(), rank=rank,
                                timeout=datetime.timedelta(seconds=DP_NCCL_PROBE_TIMEOUT))
        try:
            dist.all_reduce(torch.ones((1,), device="cuda"))
            torch.cuda.synchronize()
            msg = None
        except Exception as e:   # the refusal is what this child reports
            msg = f"{type(e).__name__}: {e}"
        with open(path, "w") as f:
            json.dump({"rank": rank, "error": msg}, f)
        try:
            dist.destroy_process_group()
        except Exception:
            pass
        return 0
    env.init_parallel_env(timeout_seconds=DP_TIMEOUT, backend="gloo")
    res = {"rank": rank, "backend": env.backend(), "device": str(env.device())}

    def write():
        with open(path, "w") as f:
            json.dump(res, f)

    res["b_f32"] = _dp_bert_rank(torch, pt, rank, "float32", 0.0)
    write()
    res["b_bf16"] = _dp_bert_rank(torch, pt, rank, "bfloat16", ATTN_DROPOUT)
    write()
    res["d"] = _dp_bert_rank(torch, pt, rank, "float32", 0.0, reduce=True,
                             ckpt_dir=os.path.join(out_dir, "ckpt"))
    write()
    res["c"] = _dp_ops(torch, rank)
    write()
    env.barrier("results written")
    # leave without the process group's C++ teardown, which has aborted a
    # gloo rank on a loaded host after every rank had written its results
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def _dp_world1(torch, pt):
    """A: BERT-base bf16 B128, dropout 0.1, on one NCCL rank: DP_STEPS plain
    ``Executor.run`` steps, then DP_STEPS through ``with_data_parallel`` from
    the same startup state, each warmed up, captured and replayed; the
    losses bit for bit, the gradient all-reduces called inside the capture
    (one a gradient; over one rank the fetched loss counts as a batch of one
    and is gathered, the identity), K1 launches a step."""
    from paddle_tpu_torch import comm
    from paddle_tpu_torch.ops import collective as coll
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel import env
    from paddle_tpu_torch.tools.train_profile import (BATCH, LR, MASKS_PER_SEQ, SEQ,
                                                      build_pretrain, pretrain_feed)
    env.init_parallel_env(timeout_seconds=DP_TIMEOUT, backend="nccl")
    cfg = bert.BertConfig(dtype="bfloat16", dropout=ATTN_DROPOUT)
    feed = pretrain_feed(np.random.RandomState(SEED), cfg, BATCH, SEQ, MASKS_PER_SEQ)
    feed = {k: torch.from_numpy(v).cuda() for k, v in feed.items()}
    main, startup, total, params_grads = build_pretrain(cfg, BATCH, SEQ, MASKS_PER_SEQ, LR,
                                                        SEED)
    init = _startup_state(pt, main, startup)
    exe = pt.Executor()
    plain, _, _ = _steps(pt, exe, main, feed, [total], init, DP_STEPS)
    exe.close()
    cp = pt.CompiledProgram(main).with_data_parallel(loss_name=total.name)
    exe = pt.Executor()
    scope = pt.Scope()
    for n, t in init.items():
        scope.set_var(n, t.clone())
    main._rng_run_counter = 0
    orig_ar, in_capture = coll.all_reduce_sum, []

    def counting(x, g):                   # an all-reduce called inside the capture
        if torch.cuda.is_current_stream_capturing():
            in_capture.append(x.numel())
        return orig_ar(x, g)

    _zero_launches()
    dp = []
    with pt.scope_guard(scope):
        for i in range(DP_STEPS):
            if i == 1:
                coll.all_reduce_sum = counting
            try:
                dp.append(exe.run(cp, feed=feed, fetch_list=[total], return_numpy=False)[0]
                          .clone())
            finally:
                coll.all_reduce_sum = orig_ar
    counts = _dp_counts()
    syncs = sum(1 for op in main.global_block().ops if op.attr(comm.rewrite.SYNC_ATTR))
    steps = [s for s in exe._cache.values()]
    exe.close()
    del exe, scope
    env.destroy_parallel_env()
    losses = [float(t.float().reshape(-1)[0]) for t in dp]
    r = dict(batch=BATCH, dtype="bfloat16", dropout=ATTN_DROPOUT,
             plain_losses=[float(o[0].float().reshape(-1)[0]) for o in plain],
             dp_losses=losses,
             bit_equal=all(torch.equal(a[0], b) for a, b in zip(plain, dp)),
             gradient_syncs=syncs, params=len(params_grads),
             all_reduces_in_capture=len(in_capture),
             all_reduced_elements=sum(in_capture),
             captured=any(s.graph is not None for s in steps),
             launches=counts, launches_per_step={k: v / DP_STEPS for k, v in counts.items()})
    emit("data_parallel_world1", **r)
    ok = (r["bit_equal"] and r["captured"] and syncs == len(params_grads)
          and len(in_capture) == syncs
          and counts["flash_attn_fwd"] + counts["flash_attn_fwd_q64"] == cfg.n_layers * DP_STEPS
          and counts["flash_attn_bwd"] == cfg.n_layers * DP_STEPS)
    if not ok:
        raise SystemExit(f"data parallel at world 1 on NCCL failed: {r}")
    return r


def _dp_one_process(torch, pt):
    """B's reference: one process, BERT-base f32 B128 at dropout 0, DP_STEPS
    steps of the plain executor on the global batches."""
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.tools.train_profile import LR, MASKS_PER_SEQ, SEQ, build_pretrain
    cfg = bert.BertConfig(dtype="float32", dropout=0.0)
    main, startup, total, _ = build_pretrain(cfg, 2 * DP_LOCAL, SEQ, MASKS_PER_SEQ, LR, SEED)
    exe, scope = pt.Executor(), pt.Scope()
    torch.cuda.reset_peak_memory_stats()
    with pt.scope_guard(scope):
        exe.run(startup)
        losses = [float(exe.run(main, feed={k: torch.from_numpy(v).cuda()
                                            for k, v in f.items()},
                                fetch_list=[total])[0].reshape(-1)[0])
                  for f in _dp_feeds(cfg)]
    peak = torch.cuda.max_memory_allocated() / 1e9
    exe.close()
    del exe, scope
    torch.cuda.empty_cache()
    return dict(losses=losses, peak_gb=peak)


def phase_data_parallel(torch, workdir, nccl_probe=False):
    """Phase 30: data parallel over torch.distributed. A: BERT-base on one
    NCCL rank through ``CompiledProgram``, captured, bit for bit to the plain
    executor; B: two ranks sharing the card over gloo, f32 at dropout 0
    against one process's B128 steps, then bf16 at dropout 0.1 (the ranks'
    masks differ, their parameters do not); C: each collective op type on
    CUDA tensors at world 2 against numpy (an op gloo refuses raises, and is
    listed; any other error fails the phase); D: ``ReduceStrategy.Reduce`` (each rank half of Adam's moments)
    and a Checkpointer round trip at world 2. E (``nccl_probe``, not in the
    whole script's run): NCCL asked for two ranks on one card, its refusal
    recorded."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import launch
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    a = _dp_world1(torch, pt)
    torch.cuda.empty_cache()
    one = _dp_one_process(torch, pt)
    emit("data_parallel_one_process", **one)
    env = {"PYTHONPATH": REPO}
    codes = launch.launch(2, [os.path.join(REPO, "chip_smoke.py"), "--dp-child", workdir,
                              "gloo"], log_dir=os.path.join(workdir, "logs"),
                          timeout=DP_TIMEOUT, env=env)
    ranks = []
    for r in range(2):
        p = os.path.join(workdir, f"gloo_rank{r}.json")
        ranks.append(json.load(open(p)) if os.path.exists(p) else {})
    if codes != [0, 0] or any("c" not in x for x in ranks):
        tails = "".join(open(os.path.join(workdir, "logs", f"rank{r}.log")).read()[-3000:]
                        for r in range(2))
        raise SystemExit(f"data parallel ranks failed: {codes}\n{tails}")
    b32 = [x["b_f32"] for x in ranks]
    b16 = [x["b_bf16"] for x in ranks]
    d = [x["d"] for x in ranks]
    gaps = [abs(x - y) / abs(y) for x, y in zip(b32[0]["losses"], one["losses"])]
    d_gaps = [abs(x - y) / abs(y) for x, y in zip(d[0]["losses"], b32[0]["losses"])]
    c_rows, refused, c_failed = {}, {}, {}
    for i, (t, attrs, shape) in enumerate(DP_OP_CASES):
        xs = [_dp_op_input(i, r, shape) for r in range(2)]
        got = [x["c"][t] for x in ranks]
        if any("error" in g for g in got):
            err = got[0].get("error") or got[1].get("error")
            (refused if GLOO_REFUSAL.search(err) else c_failed)[t] = err
            continue
        c_rows[t] = max(float(np.abs(np.asarray(g["value"], np.float32)
                                     - _dp_op_expected(t, attrs, xs, r)).max())
                        for r, g in enumerate(got))
    emit("data_parallel_ranks",
         b=dict(f32_losses=[x["losses"] for x in b32], one_process_losses=one["losses"],
                loss_rel_gaps=gaps, rtol=DP_LOSS_RTOL,
                bf16_losses=[x["losses"] for x in b16],
                bf16_launches_per_step=[x["launches_per_step"] for x in b16],
                mask_mixed_share=[x["mask_mixed_share"] for x in b16],
                step_ms={"f32": [x["step_ms"] for x in b32], "bf16": [x["step_ms"] for x in b16]},
                peak_gb={"f32": [x["peak_gb"] for x in b32], "bf16": [x["peak_gb"] for x in b16]},
                refusals=b32[0]["refusals"]),
         c=dict(max_abs_err=c_rows, refused_over_gloo=refused, failed=c_failed),
         d=dict(losses=[x["losses"] for x in d], loss_rel_gaps_to_b=d_gaps,
                moment_bytes=[x["moment_bytes"] for x in d],
                moment_bytes_declared=d[0]["moment_bytes_declared"],
                checkpoint=[x["checkpoint"] for x in d], peak_gb=[x["peak_gb"] for x in d]))
    e = None
    if nccl_probe:
        codes_e = launch.launch(2, [os.path.join(REPO, "chip_smoke.py"), "--dp-child",
                                    workdir, "nccl_shared"],
                                log_dir=os.path.join(workdir, "logs_e"),
                                timeout=DP_NCCL_PROBE_TIMEOUT + 60, env=env)
        e = []
        for r in range(2):
            p = os.path.join(workdir, f"nccl_shared_rank{r}.json")
            e.append(json.load(open(p))["error"] if os.path.exists(p) else None)
        emit("data_parallel_nccl_shared_card", codes=codes_e, errors=e)
    per = [x["launches_per_step"] for x in b16]
    ok = (max(gaps) <= DP_LOSS_RTOL
          and all(x["param_digests"] == b32[0]["param_digests"] for x in b32)
          and all(x["param_digests"] == b16[0]["param_digests"] for x in b16)
          and all(x["param_digests"] == d[0]["param_digests"] for x in d)
          and b32[0]["losses"] == b32[1]["losses"] and b16[0]["losses"] == b16[1]["losses"]
          and all(np.isfinite(x["losses"]).all() for x in b16)
          and all(s > 0 for x in b16 for s in x["mask_mixed_share"])
          and all(p["flash_attn_fwd"] + p["flash_attn_fwd_q64"] == 12
                  and p["flash_attn_bwd"] == 12 and p["dropout_fwd"] == 25
                  and p["multi_tensor_update"] == 1 for p in per)
          and not b32[0]["captured"]
          and max(d_gaps) <= DP_LOSS_RTOL
          and all(2 * x["moment_bytes"] == x["moment_bytes_declared"] for x in d)
          and all(x["checkpoint"]["saved"] == x["checkpoint"]["restored"]
                  != x["checkpoint"]["moved"] and x["checkpoint"]["step"] == DP_STEPS
                  for x in d)
          and all(v == 0.0 for v in c_rows.values()) and not c_failed
          and len(c_rows) + len(refused) == len(DP_OP_CASES)
          and "c_allreduce_avg" in c_rows and "c_allgather" in c_rows)
    r = dict(a=a, one=one, b32=b32, b16=b16, d=d, c_rows=c_rows, refused=refused, e=e,
             seconds=time.perf_counter() - t0)
    emit("data_parallel", seconds=r["seconds"], ok=ok)
    if not ok:
        raise SystemExit("data parallel phase failed (see the data_parallel_* lines)")
    return r


def main() -> int:
    if not os.path.isfile(os.path.join(REPO, "paddle_tpu_torch", "csrc",
                                       "flash_attn_fwd.cu")):
        print("chip_smoke: paddle_tpu_torch/ is not beside this script; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    if sys.argv[1:2] == ["--warm-start-child"]:
        return warm_start_child(*sys.argv[2:4])
    if sys.argv[1:2] == ["--dp-child"]:
        return dp_child(*sys.argv[2:4])
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 comparisons in full f32
    torch.backends.cudnn.allow_tf32 = False
    # a fresh autotune cache for the whole run: a decision persisted on this host by
    # an earlier run must not change the routes of phases 1-20 (default mode: cached)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tune_cache = os.path.join(REPO, "build", f"autotune_{os.getpid()}.json")
    if os.path.exists(tune_cache):
        os.remove(tune_cache)
    os.environ["PADDLE_TPU_TUNE_CACHE"] = tune_cache

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.ops import host_table
    from paddle_tpu_torch.tools.train_profile import (LR, MASKS_PER_SEQ, NMT_SEQ, SEQ,
                                                      build_deepfm, build_mnist, build_pretrain,
                                                      build_resnet50, build_transformer, lamb,
                                                      lars, transformer_config)

    t_start = time.perf_counter()
    smi = timed_phase("device", phase_device, torch)
    timed_phase("build", phase_build)
    kres = timed_phase("kernels", phase_kernels, torch)
    tres = timed_phase("train_kernels", phase_train_kernels, torch)
    timed_phase("seed_counter", phase_seed_counter, torch)
    dres = timed_phase("dropout_kernel", phase_dropout_kernel, torch)
    timed_phase("row_grads", phase_row_grads, torch)
    timed_phase("launch_breakdown", phase_launch_breakdown, torch)
    resnet = build_resnet50()                  # (main, startup, loss, params_grads, fused)
    cres = timed_phase("conv_bn_kernels", phase_conv_bn_kernels, torch,
                       resnet_fused_shapes(resnet[0], RESNET_BATCH))
    ires = timed_phase("int8_kernels", phase_int8_kernels, torch)
    timed_phase("gemm_launch_breakdown", phase_gemm_launch_breakdown, torch)
    bert_prog = build_pretrain(BertConfig(dtype="bfloat16", dropout=ATTN_DROPOUT), 2, SEQ,
                               MASKS_PER_SEQ, LR, SEED)[0]
    scratch = os.path.join(REPO, "build")      # git-ignored
    os.makedirs(scratch, exist_ok=True)
    # phase 16's chapters, read now so that phase 9 holds their update lists
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    try:
        chapters = book_setup(pt, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    programs = [("bert-base", bert_prog, "adam"),
                ("resnet50", resnet[0], "momentum"),
                ("deepfm", build_deepfm(batch=2)[0], "adam"),
                ("mnist mlp", build_mnist(batch=2)[0], "sgd"),
                ("transformer-base", build_transformer(transformer_config(), 2, NMT_SEQ)[0],
                 "adam"),
                ("bert-base lamb", build_pretrain(
                    BertConfig(dtype="bfloat16", dropout=ATTN_DROPOUT), 2,
                    SEQ, MASKS_PER_SEQ, LR, SEED, optimizer=lamb)[0], "lamb"),
                ("resnet50 lars", build_resnet50(optimizer=lars)[0], "lars_momentum"),
                ("ctr_deepfm host table",
                 build_ctr_host(pt, CTR_EXAMPLE["vocab"], name="ctr_table_phase9")[0], "adam")]
    mres = timed_phase("multi_tensor", phase_multi_tensor, torch,
                       programs + book_update_lists(chapters))
    del programs
    host_table.drop_table("ctr_table_phase9")
    mres, normed_mres, mt_host, book_mres = mres[:5], mres[5:7], mres[7], mres[8:]
    del bert_prog
    # phase 4's model directory stays until phase 27 restarts a replica from it
    serving_dir = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    atexit.register(shutil.rmtree, serving_dir, ignore_errors=True)
    serve_launches, _ = timed_phase("main_path", phase_main_path, torch, serving_dir)
    warm_run = start_cold_child(os.path.join(serving_dir, "bert_base"))   # phase 27's
    int8_launches, _ = timed_phase("int8_path", phase_int8_path, torch, serving_dir)
    torch.cuda.empty_cache()
    train_launches, step_ms, train_paths = timed_phase("train_path", phase_train_path, torch)
    torch.cuda.empty_cache()
    resnet_launches, resnet_step_ms, resnet_paths = timed_phase("resnet_train", phase_resnet_train, torch, *resnet)
    del resnet
    torch.cuda.empty_cache()
    cap_bert, cap_resnet = timed_phase("captured_training", phase_captured_training, torch)
    warm_run = start_fault_child(warm_run)                               # phase 27's
    nmt_train, nmt_decode, nmt_launches = timed_phase("transformer", phase_transformer, torch)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    try:
        ctr, mnist = timed_phase("ctr_mnist", phase_ctr_mnist, torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    try:
        e2e = timed_phase("deepfm_files", phase_deepfm_files, torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    try:
        book_chapters, vgg_serving = timed_phase("book", phase_book, torch, chapters, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    sched_bert, sched_nmt, op_card = timed_phase(
        "scheduled_training", phase_scheduled_training, torch, cap_bert["paths"],
        nmt_train["paths"])
    sched_l = {"scheduled_bert_training": sched_bert["launches"]["graph"],
               "scheduled_transformer_training": sched_nmt["launches"]["graph"]}
    torch.cuda.empty_cache()
    opt_a, opt_b, recompute_vs, opt_c, opt_d = timed_phase(
        "optimizers", phase_optimizers, torch, cap_bert["paths"], cap_resnet["paths"])
    opt_l = {"lamb_bert_training": opt_a["launches"]["graph"],
             "recompute_lamb_bert_training": opt_b["launches"]["graph"],
             "lars_resnet50_training": opt_c["launches"]["graph"]}
    mnist_opt_launches = sum(r["multi_tensor_update_launches"]["graph"] for r in opt_d)
    torch.cuda.empty_cache()
    surf_a, surf_b, surf_b2, surf_c, surf_d = timed_phase(
        "training_surface", phase_training_surface, torch, cap_bert["paths"],
        nmt_train["paths"])
    surf_l = {"pipeline_bert_training": surf_a["launches"]["graph"],
              "amp_transformer_training": surf_b["launches"]["graph"],
              "penalty_vgg16_training": surf_c["launches"]["graph"]}
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    try:
        stream_a, host_b1, host_b2 = timed_phase(
            "stream_and_host_table", phase_stream_and_host_table, torch, workdir,
            ctr["summary"]["graph_step_ms"])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    try:
        tier = timed_phase("serving_tier", phase_serving_tier, torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    try:
        det = timed_phase("detection", phase_detection, torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    slim_cf = timed_phase("slim_and_control_flow", phase_slim_and_control_flow, torch,
                          chapters, cap_resnet["paths"]["graph"]["step_ms_median_warm"])
    pruned_k2 = round(slim_cf["b"]["resnet50"]["k2_launches_per_step"] * SLIM_STEPS)
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    try:
        ocr_res = timed_phase("ocr", phase_ocr, torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    try:
        meas = timed_phase("measurement_stack", phase_measurement_stack, torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    capi_dir = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    atexit.register(shutil.rmtree, capi_dir, ignore_errors=True)
    chaos = start_chaos(capi_dir)                                        # phase 28's B
    an = timed_phase("analysis", phase_analysis, torch, meas.pop("program"))
    torch.cuda.empty_cache()
    warm = timed_phase("warm_start", phase_warm_start, torch, warm_run)
    shutil.rmtree(serving_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    try:
        capi_res = timed_phase("serving_capi", phase_serving_capi, torch, capi_dir, chaos)
    finally:
        shutil.rmtree(capi_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    try:
        dyg = timed_phase("dygraph", phase_dygraph, torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    try:
        dpr = timed_phase("data_parallel", phase_data_parallel, torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    os.remove(tune_cache)
    meas_l = meas["a"]["launches"]
    an_l = an["b"]["launches"]
    warm_k1 = warm["b"]["attention"]["k1_fwd_launches"]
    tier_l = {"tuner_search": tier["tuner_launches"],
              "serving_pool": tier["pool"]["traffic"]["launches"]}
    q64_serve = next(r for r in tier["tiles"] if r["shape"] == [8, 12, 512, 64]
                     and r["block_q"] == 64)
    q64_case = next(r for r in tier["tiles"] if r["shape"] == [128, 12, 128, 64]
                    and r["block_q"] == 64)
    q128_tiles = {f"B{r['shape'][0]} S{r['shape'][2]}": r["ms"] for r in tier["tiles"]
                  if r["block_q"] == 128 and r["shape"][1] == 12}
    # phase 29's paths: the eager BERT-base steps (B), the traced program and its
    # Predictor (C)
    dy_l = {"dygraph_bert_training": {k: dyg["b"]["f32_dropout0_launches"][k]
                                      + dyg["b"]["launches"][k]
                                      for k in dyg["b"]["launches"]},
            "dygraph_traced_serving": {k: dyg["c"]["traced_launches"][k]
                                       + dyg["c"]["serve_launches"][k]
                                       for k in dyg["c"]["serve_launches"]}}
    # phase 30's path: BERT-base data parallel (A on one NCCL rank; B and D on
    # each of the two gloo ranks)
    dp_runs = [dpr["a"]] + dpr["b32"] + dpr["b16"] + dpr["d"]
    dp_l = {k: sum(x["launches"][k] for x in dp_runs) for k in dpr["a"]["launches"]}
    book_launches = {c["chapter"]: c["train_launches"] for c in book_chapters}
    e2e_launches = e2e["epochs"]["prefetch"]["multi_tensor_update_launches"]
    ctr_launches = ctr["launches"]["graph"]["multi_tensor_update"]
    mnist_launches = mnist["launches"]["graph"]["multi_tensor_update"]

    serve_case = next(r for r in kres if r["dtype"] == "bfloat16" and r["shape"][2] == 512
                      and r["bias"] and not r["causal"])
    train_fwd, train_bwd = tres[0]             # B128 H12 S128 D64 bf16, bias, dropout 0.1
    mb_fwd, mb_bwd = tres[1]                   # B32: a microbatch of phase 19's pipeline
    fwd_err = max([r["max_abs_err"] for r in kres if r["dtype"] == "bfloat16"]
                  + [f["max_abs_err"] for f, _ in tres if f["dtype"] == "bfloat16"])
    bwd_err = max(b["max_abs_err"] for _, b in tres if b["dtype"] == "bfloat16")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    conv_case = next(r for r in cres if r["shape"] == [401408, 64, 256])
    conv_path = [r for r in cres if r["launches_per_forward_pass"]]
    int8_case = next(r for r in ires if r["shape"] == [4096, 768, 3072])
    mt_bert, mt_res, mt_ctr, mt_mnist, mt_nmt = mres
    drop_case = dres[0]                        # [16384, 768] bf16, upscale_in_train, p 0.1
    nmt_drop_case = dres[2]                    # [64, 8, 64, 64] f32, upscale_in_train, p 0.1
    vgg_drop_case = dres[3]                    # [128, 4096] f32, downgrade_in_infer, p 0.5
    drop_launches = {"captured_training": cap_bert["launches"]["graph"]["dropout_fwd"],
                     "transformer_training": nmt_launches["dropout_fwd"],
                     "image_classification_training":
                         book_launches["image_classification"]["dropout_fwd"],
                     **{k: v["dropout_fwd"] for k, v in sched_l.items()},
                     **{k: opt_l[k]["dropout_fwd"] for k in ("lamb_bert_training",
                                                             "recompute_lamb_bert_training")},
                     **{k: v["dropout_fwd"] for k, v in surf_l.items()},
                     "measurement_stack_training": meas_l.get("dropout_fwd", 0),
                     "analysis_gate_training": an_l.get("dropout_fwd", 0),
                     **{k: v["dropout_fwd"] for k, v in dy_l.items()},
                     "bert_data_parallel": dp_l["dropout_fwd"]}
    # multi_tensor_update's calls by path, each path's kind, and each kind's launches
    mt_calls = {"training": ("adam", train_launches["multi_tensor_update"]),
                "resnet50_training": ("momentum", resnet_launches["multi_tensor_update"]),
                "transformer_training": ("adam", nmt_launches["multi_tensor_update"]),
                "deepfm_training": ("adam", ctr_launches), "mnist_training": ("sgd", mnist_launches),
                "deepfm_from_files": ("adam", e2e_launches),
                **{f"book_{ch.name}": (_update_kind(ch.main),
                                       book_launches[ch.name]["multi_tensor_update"])
                   for ch, *_ in chapters},
                **{k: ("adam", v["multi_tensor_update"]) for k, v in sched_l.items()},
                "lamb_bert_training": ("lamb", opt_l["lamb_bert_training"]["multi_tensor_update"]),
                "recompute_lamb_bert_training":
                    ("lamb", opt_l["recompute_lamb_bert_training"]["multi_tensor_update"]),
                "lars_resnet50_training":
                    ("lars_momentum", opt_l["lars_resnet50_training"]["multi_tensor_update"]),
                **{f"mnist_{r['optimizer']}": (r["kind"], r["multi_tensor_update_launches"]["graph"])
                   for r in opt_d if r["kind"] is not None},
                **{k: ("adam", v["multi_tensor_update"]) for k, v in surf_l.items()},
                "amp_loss_scaling_mnist": ("sgd", surf_b2["multi_tensor_update_launches"]["graph"]),
                "stream_deepfm_uninterrupted":
                    ("adam", stream_a["uninterrupted"]["multi_tensor_update_launches"]),
                "stream_deepfm_preempted_and_resumed":
                    ("adam", stream_a["preempted"]["multi_tensor_update_launches"]
                     + stream_a["resumed"]["multi_tensor_update_launches"]),
                "stream_deepfm_arrival_merge":
                    ("adam", stream_a["arrival_merge"]["multi_tensor_update_launches"]),
                **{f"host_table_ctr_{label}_{p}": ("adam", r["multi_tensor_update_launches"][p])
                   for label, r in (("example", host_b1), ("at_scale", host_b2))
                   for p in ("graph", "eager", "graph_fetch_fault")},
                **{f"detection_yolov3_training_{p}":
                   ("adam", det["train"]["multi_tensor_update_launches"][p]
                    .get("multi_tensor_update", 0)) for p in ("graph", "eager")},
                **{f"detection_{r['model']}_training":
                   ("adam", r["multi_tensor_update_launches"].get("multi_tensor_update", 0))
                   for r in det["small"]},
                "measurement_stack_training":
                    ("adam", meas["a"]["launches"].get("multi_tensor_update", 0)),
                "analysis_gate_training": ("adam", an_l.get("multi_tensor_update", 0)),
                "install_check": ("sgd", warm["b"]["install_check_multi_tensor_update_launches"]),
                **{f"ocr_crnn_training_{p}":
                   ("momentum", ocr_res["train"]["multi_tensor_update_launches"][p]
                    .get("multi_tensor_update", 0)) for p in ("graph", "eager")},
                "bert_data_parallel": ("adam", dp_l["multi_tensor_update"])}
    kind_rows = {"adam": mt_bert, "momentum": mt_res, "sgd": mt_mnist,
                 "lamb": normed_mres[0], "lars_momentum": normed_mres[1]}
    # each kind's launches: its calls on the paths times the launches of a call
    # that phase 9 counted in its trace
    kinds = {k: {"launches": sum(n * row["launches_per_call"] for kk, n in mt_calls.values()
                                 if kk == k),
                 "calls": sum(n for kk, n in mt_calls.values() if kk == k),
                 "launches_per_call": row["launches_per_call"],
                 "max_abs_err": row["max_abs_err"], **{x: row[x] for x in keys},
                 "library": row["library"], "yardstick_ms": row.get("yardstick_ms"),
                 "shape": f"{row['model']}: {row['tensors']} parameters, {row['elements']} elements"}
             for k, row in kind_rows.items()}
    no_library = ("no single PyTorch call computes this function; matmul_ms is a bf16 "
                  "torch.matmul of the same shape, for context")
    print(smi.splitlines()[0] if smi else "nvidia-smi printed nothing", flush=True)
    print(json.dumps({"kernels": [
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_attn_fwd.cu",
         "replaces": "paddle_tpu/ops/pallas_attention.py:227",
         "launches": (serve_launches["flash_attn_fwd"] + int8_launches["flash_attn_fwd"]
                      + train_launches["flash_attn_fwd"]
                      + sched_l["scheduled_bert_training"]["flash_attn_fwd"]
                      + opt_l["lamb_bert_training"]["flash_attn_fwd"]
                      + opt_l["recompute_lamb_bert_training"]["flash_attn_fwd"]
                      + surf_l["pipeline_bert_training"]["flash_attn_fwd"]
                      + sum(v.get("flash_attn_fwd", 0) for v in tier_l.values())
                      + meas_l["flash_attn_fwd"] + an_l["flash_attn_fwd"] + warm_k1
                      + sum(v["flash_attn_fwd"] for v in dy_l.values())
                      + dp_l["flash_attn_fwd"]),
         "launches_by_path": {"serving": serve_launches["flash_attn_fwd"],
                              "int8_serving": int8_launches["flash_attn_fwd"],
                              "training": train_launches["flash_attn_fwd"],
                              "scheduled_bert_training":
                                  sched_l["scheduled_bert_training"]["flash_attn_fwd"],
                              "lamb_bert_training": opt_l["lamb_bert_training"]["flash_attn_fwd"],
                              "recompute_lamb_bert_training":
                                  opt_l["recompute_lamb_bert_training"]["flash_attn_fwd"],
                              "pipeline_bert_training":
                                  surf_l["pipeline_bert_training"]["flash_attn_fwd"],
                              **{k: v.get("flash_attn_fwd", 0) for k, v in tier_l.items()},
                              "measurement_stack_training": meas_l["flash_attn_fwd"],
                              "analysis_gate_training": an_l["flash_attn_fwd"],
                              "nets_attention": warm_k1,
                              **{k: v["flash_attn_fwd"] for k, v in dy_l.items()},
                              "bert_data_parallel": dp_l["flash_attn_fwd"]},
         "max_abs_err": fwd_err, **{k: train_fwd[k] for k in keys},
         "serving_tile_128_ms": q128_tiles,
         "shape": "B128 H12 S128 D64 bf16, bias, dropout 0.1, LSE (the training path)",
         "pipeline_microbatch": {**{k: mb_fwd[k] for k in keys},
                                 "ms_per_launch_in_scan":
                                     surf_a["kernel_in_scan"]["flash_attn_fwd"]["ms_per_launch"],
                                 "shape": "B32 H12 S128 D64 bf16, bias, dropout 0.1, LSE "
                                          "(a microbatch of phase 19's pipeline)"},
         "serving": {**{k: serve_case[k] for k in keys},
                     "shape": "B8 H12 S512 D64 bf16 with bias, no dropout, no LSE"}},
        {"name": "flash_attn_fwd_q64", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_attn_fwd.cu",
         "replaces": "paddle_tpu/ops/pallas_attention.py:227",
         "replaces_note": "the bf16 forward at 64 query rows a block (kMT 1), a tile "
                          "fused_attention.block_sizes picks between",
         "launches": (sum(v.get("flash_attn_fwd_q64", 0) for v in tier_l.values())
                      + dp_l["flash_attn_fwd_q64"]),
         "launches_by_path": {**{k: v.get("flash_attn_fwd_q64", 0) for k, v in tier_l.items()},
                              "bert_data_parallel": dp_l["flash_attn_fwd_q64"]},
         "max_abs_err": max(r["max_abs_err"] for r in tier["tiles"] if r["block_q"] == 64),
         **{k: q64_case[k] for k in keys},
         "shape": "B128 H12 S128 D64 bf16 with bias, no dropout, no LSE",
         "serving": {**{k: q64_serve[k] for k in keys},
                     "shape": "B8 H12 S512 D64 bf16 with bias, no dropout, no LSE"}},
        {"name": "flash_attn_bwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_attn_bwd.cu",
         "replaces": "paddle_tpu/ops/pallas_attention.py:260",
         "launches": (train_launches["flash_attn_bwd"]
                      + sched_l["scheduled_bert_training"]["flash_attn_bwd"]
                      + opt_l["lamb_bert_training"]["flash_attn_bwd"]
                      + opt_l["recompute_lamb_bert_training"]["flash_attn_bwd"]
                      + surf_l["pipeline_bert_training"]["flash_attn_bwd"]
                      + meas_l["flash_attn_bwd"] + an_l["flash_attn_bwd"]
                      + sum(v["flash_attn_bwd"] for v in dy_l.values())
                      + dp_l["flash_attn_bwd"]),
         "launches_by_path": {"training": train_launches["flash_attn_bwd"],
                              "scheduled_bert_training":
                                  sched_l["scheduled_bert_training"]["flash_attn_bwd"],
                              "lamb_bert_training": opt_l["lamb_bert_training"]["flash_attn_bwd"],
                              "recompute_lamb_bert_training":
                                  opt_l["recompute_lamb_bert_training"]["flash_attn_bwd"],
                              "pipeline_bert_training":
                                  surf_l["pipeline_bert_training"]["flash_attn_bwd"],
                              "measurement_stack_training": meas_l["flash_attn_bwd"],
                              "analysis_gate_training": an_l["flash_attn_bwd"],
                              **{k: v["flash_attn_bwd"] for k, v in dy_l.items()},
                              "bert_data_parallel": dp_l["flash_attn_bwd"]},
         "max_abs_err": bwd_err,
         **{k: train_bwd[k] for k in keys},
         "shape": "B128 H12 S128 D64 bf16, bias, dropout 0.1 (the training path)",
         "pipeline_microbatch": {**{k: mb_bwd[k] for k in keys},
                                 "ms_per_launch_in_scan":
                                     surf_a["kernel_in_scan"]["flash_attn_bwd"]["ms_per_launch"],
                                 "shape": "B32 H12 S128 D64 bf16, bias, dropout 0.1 "
                                          "(a microbatch of phase 19's pipeline)"}},
        {"name": "fused_conv1x1_bn_fwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/conv1x1_bn.cu",
         "replaces": "paddle_tpu/ops/pallas_conv_bn.py:124",
         "launches": (resnet_launches["fused_conv1x1_bn_fwd"]
                      + opt_l["lars_resnet50_training"]["fused_conv1x1_bn_fwd"] + pruned_k2),
         "launches_by_path": {"resnet50_training": resnet_launches["fused_conv1x1_bn_fwd"],
                              "lars_resnet50_training":
                                  opt_l["lars_resnet50_training"]["fused_conv1x1_bn_fwd"],
                              "pruned_resnet50_training": pruned_k2},
         "max_abs_err": max(r["max_abs_err"] for r in cres if r["dtype"] == "bfloat16"),
         **{k: conv_case[k] for k in keys}, "matmul_ms": conv_case["matmul_ms"],
         "library_note": no_library,
         "shape": "M 401408 K 64 N 256 bf16, no prologue (4 of the 33 chains)",
         "forward_pass": {"launches": 33,
                          **{k: sum(r[k] * r["launches_per_forward_pass"] for r in conv_path)
                             for k in ("ms", "plain_ms", "bound_ms", "matmul_ms")}}},
        {"name": "int8_matmul", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/int8_matmul.cu",
         "replaces": "paddle_tpu/ops/pallas_int8.py:83",
         "launches": int8_launches["int8_matmul"],
         "launches_by_path": {"int8_serving": int8_launches["int8_matmul"]},
         "max_abs_err": max(r["max_abs_err"] for r in ires),
         **{k: int8_case[k] for k in keys}, "matmul_ms": int8_case["matmul_ms"],
         "library_note": no_library,
         "shape": "M 4096 K 768 N 3072 bf16 activations (ffn1 at 8 x 512 tokens)"},
        {"name": "dropout", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/dropout.cu",
         "replaces": "paddle_tpu/ops/nn_ops.py:333",
         "replaces_note": ("no Pallas kernel: the draw of the JAX dropout lowering "
                           "(jax.random.bernoulli inside the compiled step)"),
         "launches": sum(drop_launches.values()),
         "launches_by_path": drop_launches,
         "max_abs_err": max(r["max_abs_err"] for r in dres),
         **{k: drop_case[k] for k in keys}, "library": drop_case["library"],
         "shape": "[16384, 768] bf16, upscale_in_train, p 0.1 (BERT-base's hidden dropout)",
         "transformer": {**{k: nmt_drop_case[k] for k in keys},
                         "library": nmt_drop_case["library"],
                         "shape": ("[64, 8, 64, 64] f32, upscale_in_train, p 0.1 "
                                   "(transformer-base's attention-probs dropout)")},
         "vgg16": {**{k: vgg_drop_case[k] for k in keys}, "library": vgg_drop_case["library"],
                   "shape": ("[128, 4096] f32, downgrade_in_infer, p 0.5 (VGG-16's fc "
                             "dropouts in the image chapter)")}},
        {"name": "multi_tensor_update", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/multi_tensor_update.cu", "in_place": True,
         "replaces": "paddle_tpu/compiler.py:94",
         "replaces_note": ("no Pallas kernel: fuse_all_optimizer_ops, under which XLA "
                           "updates every parameter inside the one compiled step"),
         "launches": sum(n for _, n in mt_calls.values()),
         "launches_by_path": {k: n for k, (_, n) in mt_calls.items()},
         "launches_note": ("calls of the wrapper, one a step on each path; kinds gives each "
                           "kind's kernel launches a call, counted in phase 9's trace, and "
                           "its kernel launches on the paths"),
         "kinds": kinds,
         "max_abs_err": max(r["max_abs_err"] for r in mres + normed_mres + [mt_host] + book_mres),
         **{k: mt_bert[k] for k in keys}, "library": mt_bert["library"],
         "shape": (f"BERT-base's {mt_bert['tensors']} Adam parameters, "
                   f"{mt_bert['elements']} elements, bf16 and f32, f32 moments"),
         "resnet50": {**{k: mt_res[k] for k in keys}, "library": mt_res["library"],
                      "shape": (f"ResNet-50's {mt_res['tensors']} Momentum parameters, "
                                f"{mt_res['elements']} elements, bf16, f32 velocity")},
         "deepfm": {**{k: mt_ctr[k] for k in keys}, "library": mt_ctr["library"],
                    "shape": (f"DeepFM's {mt_ctr['tensors']} Adam parameters, "
                              f"{mt_ctr['elements']} elements, f32")},
         "ctr_host_table": {**{k: mt_host[k] for k in keys}, "library": mt_host["library"],
                            "shape": (f"ctr_deepfm's {mt_host['tensors']} dense Adam "
                                      f"parameters (the table is on the host), "
                                      f"{mt_host['elements']} elements, f32")},
         "mnist": {**{k: mt_mnist[k] for k in keys}, "library": mt_mnist["library"],
                   "shape": (f"the MNIST MLP's {mt_mnist['tensors']} SGD parameters, "
                             f"{mt_mnist['elements']} elements, f32")},
         "transformer": {**{k: mt_nmt[k] for k in keys}, "library": mt_nmt["library"],
                         "shape": (f"transformer-base's {mt_nmt['tensors']} Adam parameters, "
                                   f"{mt_nmt['elements']} elements, f32")},
         "book": {r["model"]: {**{k: r[k] for k in keys}, "library": r["library"],
                               "shape": (f"{r['tensors']} {r['kind']} parameters, "
                                         f"{r['elements']} elements, "
                                         f"{'/'.join(r['param_dtypes'])}")}
                  for r in book_mres}}],
        "captured_step_ms": {
            name: {p: r["paths"][p]["step_ms_median_warm"] for p in ("graph", "eager")}
            for name, r in (("bert_base", cap_bert), ("resnet50", cap_resnet),
                            ("transformer_base", nmt_train), ("deepfm", ctr),
                            ("mnist_mlp", mnist))},
        "scheduled_step_ms": {
            name: {"scheduled": r["step_ms"], "constant_lr": r["constant_lr_step_ms"],
                   "lr": r["lr"]["graph"], "counters": r["counters"]["graph"]}
            for name, r in (("bert_base", sched_bert), ("transformer_base", sched_nmt))},
        "optimizer_step_ms": {
            name: {"graph": r["step_ms"]["graph"], "eager": r["step_ms"]["eager"],
                   "constant_lr_graph": r["constant_lr_step_ms"]["graph"],
                   "device_busy_ms": r["device_busy_ms"]["graph"],
                   "graph_pool_gb": max(r["graph_pool_gb"]),
                   "work_tables_built": r["work_tables_built"]}
            for name, r in (("A_bert_base_lamb", opt_a), ("B_bert_base_recompute_lamb", opt_b),
                            ("C_resnet50_lars", opt_c))},
        "recompute_vs_lamb": {k: recompute_vs[k] for k in ("loss_rel_gap", "update_rel_l1_gap",
                                                           "state_bit_equal", "graph_pool_gb")},
        "mnist_optimizers": {r["optimizer"]: r["losses"][-1] for r in opt_d},
        "pipeline_step_ms": {"graph": surf_a["step_ms"]["graph"], "eager": surf_a["step_ms"]["eager"],
                             "plain_b128_graph": surf_a["constant_lr_step_ms"]["graph"],
                             "graph_pool_gb": max(surf_a["graph_pool_gb"]),
                             "eager_peak_gb": surf_a["eager_peak_gb"],
                             "A0_loss_rel_gap": surf_a["A0"]["loss_rel_gap"],
                             "A0_update_rel_l1_gap": surf_a["A0"]["update_rel_l1_gap"]},
        "amp_step_ms": {"graph": surf_b["step_ms"]["graph"], "eager": surf_b["step_ms"]["eager"],
                        "f32_graph": surf_b["constant_lr_step_ms"]["graph"],
                        "casts_inserted": surf_b["casts_inserted"],
                        "step1_loss_rel_gap": surf_b["step1_loss_rel_gap"],
                        "loss_scales": surf_b2["scales"]["graph"]},
        "second_order_step_ms": {"graph": surf_c["step_ms"]["graph"],
                                 "eager": surf_c["step_ms"]["eager"],
                                 "plain_chapter_graph": surf_c["constant_lr_step_ms"]["graph"],
                                 "penalty": surf_c["losses"]["graph"],
                                 "graph_pool_gb": max(surf_c["graph_pool_gb"])},
        "double_grad_cases_on_card": {c["case"]: c["max_abs_err"] for c in surf_d["cases"]},
        "stream_step_ms": {"guarded_captured_median": stream_a["uninterrupted"]["step_ms_median"],
                           "deepfm_from_feeds_graph": stream_a["deepfm_from_feeds_graph_step_ms"],
                           "records_per_s": stream_a["uninterrupted"]["records_per_s"],
                           "idle_share_resumed": stream_a["resumed"]["idle_share_profiled"],
                           "restore_s": stream_a["resumed"]["restore_s"]},
        "resume_bit_equal": stream_a["resume_bit_equal"],
        "resume_arrival_merge_exactly_once": stream_a["arrival_merge"]["exactly_once"],
        "fetch_fault_retry_bit_equal": {"example": host_b1["fetch_fault_retry_bit_equal"],
                                        "at_scale": host_b2["fetch_fault_retry_bit_equal"]},
        "host_table_push_ms": {"at_scale": host_b2["push_ms_median"],
                               "at_scale_parts": host_b2["push_parts_ms"],
                               "at_scale_gather": host_b2["gather_ms_median"],
                               "example": host_b1["push_ms_median"],
                               "at_scale_step_ms": host_b2["step_ms"],
                               "at_scale_idle_share": host_b2["idle_share_profiled"]},
        "op_cases_on_card": {k: op_card[k] for k in ("cases", "op_types", "grads",
                                                     "forward_max_abs_err", "grad_max_abs_err")},
        "deepfm_serving_ms": {str(q["batch"]): q["ms"] for q in ctr["serving"]["requests"]},
        "book_step_ms": {c["chapter"]: c["step_ms"] for c in book_chapters},
        "book_metrics": {c["chapter"]: c["metrics"] for c in book_chapters},
        "vgg16_serving_ms": {f"{r['dtype']} mb{r['batch']}": r["ms"] for r in vgg_serving},
        "deepfm_from_files_s": {k: e2e["epochs"][k]["seconds"] for k in e2e["epochs"]},
        "deepfm_parse_only_s": e2e["parse_only_s"],
        "transformer_decode_ms": {p: nmt_decode["paths"][p]["decode_ms_median_warm"]
                                  for p in ("graph", "eager")},
        "train_step_ms": step_ms, "resnet_step_ms": resnet_step_ms,
        "reference_path_step_ms": {
            "training": train_paths["reference"]["step_ms_median_warm"],
            "resnet50_training": resnet_paths["reference"]["step_ms_median_warm"]},
        "serving_pool": {k: tier["pool"]["traffic"][k] for k in (
            "requests", "byte_equal_to_solo", "max_ulps_to_solo", "p50_ms", "p99_ms",
            "requests_per_s", "idle_share", "k1_fwd_launches_per_replay")},
        "fuse_steps_search": {k: tier["fuse"][k] for k in ("k", "timings_ms_per_step",
                                                           "state_bit_equal")},
        "out_of_range_gather_on_card": tier["probes"]["gather"],
        "detection": {
            "yolov3_step_ms": det["train"]["step_ms"],
            "yolov3_f32_bound_ms": det["train"]["f32_bound_ms"],
            "yolov3_losses": det["train"]["losses"],
            "yolov3_idle_share": det["train"]["idle_share"],
            "yolov3_serving_p50_ms": {str(r["batch"]): r["p50_ms"] for r in det["serving"]},
            "nms_device_ms": {str(r["batch"]): r["nms_device_ms"] for r in det["serving"]},
            "nms_kernel_launches": {str(r["batch"]): r["nms"]["kernel_launches"]
                                    for r in det["serving"]},
            "small_detectors_losses": {r["model"]: r["losses"] for r in det["small"]},
            "op_types_on_card": len(det["op_types"]), "cases_on_card": len(det["cases"]),
            "seconds": det["seconds"]},
        "slim_and_control_flow": {
            "while_step_ms": {k: slim_cf["a"]["while_training"][f"step_ms_{k}"]
                              for k in ("graph", "eager")},
            "while_step1_rel_gap": slim_cf["a"]["while_training"]["step1_batch2"]["rel_gap"],
            "unbounded_while": {k: slim_cf["a"]["unbounded_while"][k] for k in (
                "refusal", "run_ms", "device_activities_per_run", "idle_share")},
            "ifelse_switch_step_ms": slim_cf["a"]["ifelse_switch"]["step_ms_graph"],
            "dynamic_rnn_lstm_step_ms": slim_cf["a"]["dynamic_rnn_lstm"]["step_ms_graph"],
            "dynamic_rnn_lstm_losses": slim_cf["a"]["dynamic_rnn_lstm"]["losses"],
            "pruned_resnet50_step_ms": slim_cf["b"]["resnet50"]["step_ms_median_warm"],
            "unpruned_resnet50_step_ms": slim_cf["b"]["resnet50"]["unpruned_step_ms_phase8"],
            "pruned_k2_launches_per_step": slim_cf["b"]["resnet50"]["k2_launches_per_step"],
            "prune_example_final": slim_cf["b"]["example"]["final"],
            "vision_cases_on_card": len(slim_cf["c"]["cases"]),
            "vision_worst_rel_err": max(max(r["forward_rel_err"], r["grad_rel_err"])
                                        for r in slim_cf["c"]["cases"]),
            "nchw_s2d_step1_loss_rel_gap": slim_cf["c"]["nchw_s2d_step1"]["loss_rel_gap"],
            "seconds": slim_cf["seconds"]},
        "ocr": {
            "crnn_step_ms": {p: ocr_res["train"][f"step_ms_{p}"] for p in ("graph", "eager")},
            "crnn_losses": ocr_res["train"]["losses"],
            "crnn_launches_per_step": ocr_res["train"]["launches_per_step"],
            "crnn_idle_share": ocr_res["train"]["idle_share"],
            "crnn_step1_loss_rel_gap": ocr_res["train"]["step1_batch2"]["loss_rel_gap"],
            "crnn_serving_p50_ms": {str(r["batch"]): r["p50_ms"] for r in ocr_res["serving"]},
            "extra_cases_on_card": len(ocr_res["cases"]["rows"]),
            "warpctc_vs_ctc_loss_ms": [ocr_res["yardstick"]["warpctc_fwd_bwd_ms"],
                                       ocr_res["yardstick"]["ctc_loss_fwd_bwd_ms"]],
            "seconds": ocr_res["seconds"]},
        "measurement_stack": {
            "goodput": {k: meas["a"]["goodput"][k] for k in ("fraction", "wall_s",
                                                              "causes_sum_s")},
            "program_flops": meas["a"]["program_flops"]["total"],
            "hand_count_flops": meas["a"]["hand_count_flops"],
            "program_mfu": meas["a"]["program_mfu"], "peak_flops": meas["a"]["peak_flops"],
            "flagged_steps": meas["a"]["flagged_steps"],
            "attributed_device_fraction": meas["b"]["attributed_device_fraction"],
            "slo_transitions": [t["active"] for t in meas["c"]["transitions"]],
            "profiler_k1_kernels": meas["d"]["k1_kernels"], "seconds": meas["seconds"]},
        "analysis": {
            "programs": {r["program"]: {"ops": r["ops"], "findings": r["findings"],
                                        "verify_s": r["verify_s"]} for r in an["a"]},
            "gate_verify_span_s": an["b"]["verify_span_s"],
            "static_peak_bytes": an["b"]["static_peak_bytes"],
            "argument_bytes": an["b"]["argument_bytes"], "pool_bytes": an["b"]["pool_bytes"],
            "static_peak_ratio": an["b"]["static_peak_ratio"],
            "budget_refusal": an["c"]["codes"],
            "pt060": [x["op"] for x in an["d"]["pt060"]], "seconds": an["seconds"]},
        "warm_start": {
            label: {k: warm["a"][label][k] for k in (
                "total_s", "import_s", "model_load_s", "nvcc", "nvcc_s", "restored",
                "restore_s", "warmup_s", "time_to_first_answer_s", "flush_s", "captures")}
            | {"buckets": {str(r["batch"]): [r["warm_up_s"], r["capture_s"]]
                           for r in warm["a"][label]["buckets"]}}
            for label in ("cold", "warm", "corrupted_library")}
        | {"checks": warm["a"]["checks"],
           "nets_attention_max_abs_err": warm["b"]["attention"]["max_abs_err"],
           "seconds": warm["seconds"]},
        "serving_capi": {
            "ms": {f"{r['dtype']} mb{r['batch']}": r["ms"] for r in capi_res["a"]["rows"]},
            "flops_share": {f"{r['dtype']} mb{r['batch']}": r["flops_share"]
                            for r in capi_res["a"]["rows"]},
            "byte_equal_to_python": all(r["byte_equal_to_python"] for r in capi_res["a"]["rows"]),
            "threads_equal_to_solo": all(t["bytes_equal_to_solo"]
                                         for t in capi_res["a"]["threads"]),
            "chaos_events": capi_res["b"]["steps"]["events"],
            "stream_chaos_ok": capi_res["b"]["stream"]["ok"],
            "tools_rc": capi_res["c"]["rc"], "seconds": capi_res["seconds"]},
        "dygraph": {
            "tape_attention": {"max_abs_err": dyg["a"]["max_abs_err"],
                               "grads_max_abs_err": {n: g["max_abs_err"]
                                                     for n, g in dyg["a"]["grads"].items()},
                               "launches": dyg["a"]["launches"]},
            "static_losses": dyg["b"]["static_losses"], "eager_losses": dyg["b"]["eager_losses"],
            "loss_rel_gaps": dyg["b"]["loss_rel_gaps"],
            "dropout_losses": dyg["b"]["dropout_losses"],
            "eager_step_ms_median_last4": dyg["b"]["step_ms_median_last4"],
            "forward_backward_update_ms": dyg["b"]["forward_backward_update_ms"],
            "device_busy_ms": dyg["b"]["device_busy_ms"], "idle_share": dyg["b"]["idle_share"],
            "launches_per_step": dyg["b"]["launches_per_step"],
            "traced_max_abs_err": [dyg["c"]["traced_max_abs_err"],
                                   dyg["c"]["traced_b1_max_abs_err"]],
            "predictor_max_abs_err": dyg["c"]["predictor_max_abs_err"],
            "k1_fwd_per_request": dyg["c"]["k1_fwd_per_request"],
            "checkpoint_round_trip": dyg["d"]["ok"], "seconds": dyg["seconds"]},
        "data_parallel": {
            "world1_nccl_bit_equal": dpr["a"]["bit_equal"],
            "world1_gradient_syncs": dpr["a"]["gradient_syncs"],
            "gloo_f32_losses": dpr["b32"][0]["losses"],
            "one_process_losses": dpr["one"]["losses"],
            "gloo_bf16_losses": dpr["b16"][0]["losses"],
            "gloo_step_ms": {"f32": dpr["b32"][0]["step_ms"], "bf16": dpr["b16"][0]["step_ms"],
                             "reduce": dpr["d"][0]["step_ms"]},
            "peak_gb": {p: [x["peak_gb"] for x in dpr[p]] for p in ("b32", "b16", "d")},
            "reduce_moment_bytes": [x["moment_bytes"] for x in dpr["d"]],
            "ops_refused_over_gloo_on_cuda": sorted(dpr["refused"]),
            "seconds": dpr["seconds"]},
        "seconds": time.perf_counter() - t_start}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
