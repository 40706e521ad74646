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
VGG-16 under a gradient penalty through the PyTorch/CUDA port on one NVIDIA
GPU, and hold its CUDA kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA. Phases, each printing JSON lines:

1. device: the card, its power limit, the toolchain;
2. build: compile every kernel of ``paddle_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel);
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
   CPU Predictor and the unquantized bf16 model (the int8 accuracy cost);
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
   elements, the 1,000,000 x 16 table among them), the MNIST MLP's 6 SGD
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
12. the kernels line (``multi_tensor_update`` with its five kinds, each
   with its launches), then the result line.

Exits non-zero, with no result line, when there is no CUDA card, when the
port's sources are not beside this script, or when any phase fails.
"""
from __future__ import annotations

import gc
import json
import os
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
    """Every kernel (one ``nvcc`` each) and the native slot parser (``g++``),
    all started together."""
    import threading
    from paddle_tpu_torch import native
    from paddle_tpu_torch.core import cuda_build
    names = list(cuda_build.SOURCES)
    t0 = time.perf_counter()
    parser = threading.Thread(target=native.available)
    parser.start()
    paths = cuda_build.build(names)
    parser.join()
    seconds = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in cuda_build.build_logs.get(n, "").splitlines()
                 if "registers" in ln or "spill" in ln] for n in names}
    emit("build", kernels=names, seconds=seconds,
         libraries=[os.path.relpath(p, REPO) for p in paths.values()], ptxas=ptxas,
         native_parser=os.path.relpath(native.library_path(), REPO),
         native_parser_error=native.build_error)
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


def _graph_launches(torch, fn, names):
    """The kernel launches of one call of ``fn`` by each of ``names``: the
    kernel nodes of a CUDA graph that captures the call, read from its DOT
    dump (``CUDAGraph.debug_dump``; a capture records and runs nothing).
    Exact, where a profiler trace may lose its first records (ROADMAP 3.2)."""
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
                profile_steps(torch, exe, main, feed, loss, 3)
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
    t0 = time.perf_counter()
    cpu_out = Predictor(int8_dir, device="cpu").run(requests[0])[0]
    cpu_s = time.perf_counter() - t0
    gaps = {}
    for name, a, b in (("kernel_vs_card_plain", outs[0], plain_out),
                       ("card_vs_cpu_plain", outs[0], cpu_out),
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
        launches = _launch_times(torch, call, 5)
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
        plain = _breakdown("update_plain", None, _launch_times(torch, plain_call, 3))
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
            library_ms = _breakdown(library, None, _launch_times(torch, fn, 5))[
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
CAPTURED_STEPS = 5           # steps held graph against eager
TIMED_STEPS = 6              # steps timed on each path (after the held ones)
# an eager path, host-bound and the slower one, is timed over fewer steps (its
# median over the last 3) and traced over 2 (after the profiler's warm-up step),
# to keep the whole script near half its time limit on a slow host
EAGER_TIMED_STEPS, EAGER_PROFILED_STEPS = 4, 2
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
    pools, then 3 steps (EAGER_PROFILED_STEPS eager) under the profiler, with
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
        prof = profile_steps(torch, exe, main, feed, loss,
                             3 if graphs_on else EAGER_PROFILED_STEPS)
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


def _memory_before_after(torch, pt, main, feed, loss, init):
    """Part 6: the eager step's peak and the graph's pool with every
    intermediate kept to the step's end, and with each freed after its
    last reader."""
    out = {}
    for free in (False, True):
        row = {}
        for graphs_on in (False, True):
            exe = pt.Executor()
            exe._use_graphs, exe._free_dead = graphs_on, free
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
        out["freed_after_last_reader" if free else "kept_to_step_end"] = row
    return out


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
    r["memory_before_after_freeing"] = _memory_before_after(torch, pt, main, feed, loss, init)
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
DECODE_BATCH, DECODE_BEAM, DECODE_MAX_LEN, DECODE_RUNS = 8, 4, 16, 6
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
    graph pools, the profile of 3 more)."""
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
        prof = profile_steps(torch, exe, main, feed, fetch, 3)
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


def _write_ctr_parts(d, fields, vocab, n_rows=E2E_ROWS, n_parts=E2E_PARTS):
    """The part files as ``bench_workloads.py::_deepfm_e2e_body`` writes them,
    from ``RandomState(SEED)``: 26 ids < 2^24, 13 dense features and a label
    a line, slots ``;``-separated."""
    rng = np.random.RandomState(SEED)
    paths = []
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
    paths = _write_ctr_parts(workdir, CTR_FIELDS, CTR_VOCAB)
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
PIPE_STEPS = SCHED_STEPS
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
    # the trace of 3 captured steps
    graph = r["paths"]["graph"]
    recs, rec_ms = graph.pop("device_records"), graph.pop("device_ms_by_record")
    in_scan = {}
    for kernel, pats in (("flash_attn_fwd", ("flash_fwd",)),
                         ("flash_attn_bwd", ("bwd_dkdv", "bwd_dq", "flash_bwd"))):
        names = [k for k in recs if any(p_ in k for p_ in pats)]
        n = sum(recs[k] for k in names) / 3
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
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 comparisons in full f32
    torch.backends.cudnn.allow_tf32 = False

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.tools.train_profile import (LR, MASKS_PER_SEQ, NMT_SEQ, SEQ,
                                                      build_deepfm, build_mnist, build_pretrain,
                                                      build_resnet50, build_transformer, lamb,
                                                      lars, transformer_config)

    t_start = time.perf_counter()
    smi = phase_device(torch)
    phase_build()
    kres = phase_kernels(torch)
    tres = phase_train_kernels(torch)
    phase_seed_counter(torch)
    dres = phase_dropout_kernel(torch)
    phase_row_grads(torch)
    phase_launch_breakdown(torch)
    resnet = build_resnet50()                  # (main, startup, loss, params_grads, fused)
    cres = phase_conv_bn_kernels(torch, resnet_fused_shapes(resnet[0], RESNET_BATCH))
    ires = phase_int8_kernels(torch)
    phase_gemm_launch_breakdown(torch)
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
    mres = phase_multi_tensor(torch, [("bert-base", bert_prog, "adam"),
                                      ("resnet50", resnet[0], "momentum"),
                                      ("deepfm", build_deepfm(batch=2)[0], "adam"),
                                      ("mnist mlp", build_mnist(batch=2)[0], "sgd"),
                                      ("transformer-base",
                                       build_transformer(transformer_config(), 2, NMT_SEQ)[0],
                                       "adam"),
                                      ("bert-base lamb", build_pretrain(
                                          BertConfig(dtype="bfloat16", dropout=ATTN_DROPOUT), 2,
                                          SEQ, MASKS_PER_SEQ, LR, SEED, optimizer=lamb)[0],
                                       "lamb"),
                                      ("resnet50 lars", build_resnet50(optimizer=lars)[0],
                                       "lars_momentum")] + book_update_lists(chapters))
    mres, normed_mres, book_mres = mres[:5], mres[5:7], mres[7:]
    del bert_prog
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    try:
        serve_launches, _ = phase_main_path(torch, workdir)
        int8_launches, _ = phase_int8_path(torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    train_launches, step_ms, train_paths = phase_train_path(torch)
    torch.cuda.empty_cache()
    resnet_launches, resnet_step_ms, resnet_paths = phase_resnet_train(torch, *resnet)
    del resnet
    torch.cuda.empty_cache()
    cap_bert, cap_resnet = phase_captured_training(torch)
    nmt_train, nmt_decode, nmt_launches = phase_transformer(torch)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    try:
        ctr, mnist = phase_ctr_mnist(torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    try:
        e2e = phase_deepfm_files(torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    try:
        book_chapters, vgg_serving = phase_book(torch, chapters, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    sched_bert, sched_nmt, op_card = phase_scheduled_training(torch, cap_bert["paths"],
                                                              nmt_train["paths"])
    sched_l = {"scheduled_bert_training": sched_bert["launches"]["graph"],
               "scheduled_transformer_training": sched_nmt["launches"]["graph"]}
    torch.cuda.empty_cache()
    opt_a, opt_b, recompute_vs, opt_c, opt_d = phase_optimizers(torch, cap_bert["paths"],
                                                                cap_resnet["paths"])
    opt_l = {"lamb_bert_training": opt_a["launches"]["graph"],
             "recompute_lamb_bert_training": opt_b["launches"]["graph"],
             "lars_resnet50_training": opt_c["launches"]["graph"]}
    mnist_opt_launches = sum(r["multi_tensor_update_launches"]["graph"] for r in opt_d)
    torch.cuda.empty_cache()
    surf_a, surf_b, surf_b2, surf_c, surf_d = phase_training_surface(torch, cap_bert["paths"],
                                                                     nmt_train["paths"])
    surf_l = {"pipeline_bert_training": surf_a["launches"]["graph"],
              "amp_transformer_training": surf_b["launches"]["graph"],
              "penalty_vgg16_training": surf_c["launches"]["graph"]}
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
                     **{k: v["dropout_fwd"] for k, v in surf_l.items()}}
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
                "amp_loss_scaling_mnist": ("sgd", surf_b2["multi_tensor_update_launches"]["graph"])}
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
                      + surf_l["pipeline_bert_training"]["flash_attn_fwd"]),
         "launches_by_path": {"serving": serve_launches["flash_attn_fwd"],
                              "int8_serving": int8_launches["flash_attn_fwd"],
                              "training": train_launches["flash_attn_fwd"],
                              "scheduled_bert_training":
                                  sched_l["scheduled_bert_training"]["flash_attn_fwd"],
                              "lamb_bert_training": opt_l["lamb_bert_training"]["flash_attn_fwd"],
                              "recompute_lamb_bert_training":
                                  opt_l["recompute_lamb_bert_training"]["flash_attn_fwd"],
                              "pipeline_bert_training":
                                  surf_l["pipeline_bert_training"]["flash_attn_fwd"]},
         "max_abs_err": fwd_err, **{k: train_fwd[k] for k in keys},
         "shape": "B128 H12 S128 D64 bf16, bias, dropout 0.1, LSE (the training path)",
         "pipeline_microbatch": {**{k: mb_fwd[k] for k in keys},
                                 "ms_per_launch_in_scan":
                                     surf_a["kernel_in_scan"]["flash_attn_fwd"]["ms_per_launch"],
                                 "shape": "B32 H12 S128 D64 bf16, bias, dropout 0.1, LSE "
                                          "(a microbatch of phase 19's pipeline)"},
         "serving": {**{k: serve_case[k] for k in keys},
                     "shape": "B8 H12 S512 D64 bf16 with bias, no dropout, no LSE"}},
        {"name": "flash_attn_bwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_attn_bwd.cu",
         "replaces": "paddle_tpu/ops/pallas_attention.py:260",
         "launches": (train_launches["flash_attn_bwd"]
                      + sched_l["scheduled_bert_training"]["flash_attn_bwd"]
                      + opt_l["lamb_bert_training"]["flash_attn_bwd"]
                      + opt_l["recompute_lamb_bert_training"]["flash_attn_bwd"]
                      + surf_l["pipeline_bert_training"]["flash_attn_bwd"]),
         "launches_by_path": {"training": train_launches["flash_attn_bwd"],
                              "scheduled_bert_training":
                                  sched_l["scheduled_bert_training"]["flash_attn_bwd"],
                              "lamb_bert_training": opt_l["lamb_bert_training"]["flash_attn_bwd"],
                              "recompute_lamb_bert_training":
                                  opt_l["recompute_lamb_bert_training"]["flash_attn_bwd"],
                              "pipeline_bert_training":
                                  surf_l["pipeline_bert_training"]["flash_attn_bwd"]},
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
                      + opt_l["lars_resnet50_training"]["fused_conv1x1_bn_fwd"]),
         "launches_by_path": {"resnet50_training": resnet_launches["fused_conv1x1_bn_fwd"],
                              "lars_resnet50_training":
                                  opt_l["lars_resnet50_training"]["fused_conv1x1_bn_fwd"]},
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
         "max_abs_err": max(r["max_abs_err"] for r in mres + normed_mres + book_mres),
         **{k: mt_bert[k] for k in keys}, "library": mt_bert["library"],
         "shape": (f"BERT-base's {mt_bert['tensors']} Adam parameters, "
                   f"{mt_bert['elements']} elements, bf16 and f32, f32 moments"),
         "resnet50": {**{k: mt_res[k] for k in keys}, "library": mt_res["library"],
                      "shape": (f"ResNet-50's {mt_res['tensors']} Momentum parameters, "
                                f"{mt_res['elements']} elements, bf16, f32 velocity")},
         "deepfm": {**{k: mt_ctr[k] for k in keys}, "library": mt_ctr["library"],
                    "shape": (f"DeepFM's {mt_ctr['tensors']} Adam parameters, "
                              f"{mt_ctr['elements']} elements, f32")},
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
        "seconds": time.perf_counter() - t_start}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
