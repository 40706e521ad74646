#!/usr/bin/env python3
"""Serve BERT-base (bf16 and int8), train BERT-base and ResNet-50 through the
PyTorch/CUDA port on one NVIDIA GPU, and hold its CUDA kernels against their
plain PyTorch versions.

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
9. multi_tensor_update over BERT-base's 158 Adam parameters and
   ResNet-50's 161 Momentum parameters (their shapes and dtypes read from
   the programs), in place, against the per-op lowerings on the card, bit
   for bit, with its time, its bound, the per-op path's time (device and
   host), its own host time per call and ``torch._fused_adam_`` /
   ``torch._fused_sgd_`` on f32 copies of the same tensors as yardsticks;
10. (run after phase 3) the run counter on the card: K1-fwd, K1-bwd and
   the dropout kernel given a ``DeviceSeed`` draw bit for bit what they
   draw for the host
   seed of the same counter (0, 1, 2^31, 2^32 + 5), and two counters two
   masks; the dropout kernel against its plain version, bit for bit, at
   BERT-base's hidden-dropout shape ([16384, 768] bf16, p 0.1, both
   implementations), in f32, ragged, unaligned and at p 0 and 1, with its
   time, bound and ``F.dropout``'s time; the gradients of
   ``lookup_table_v2`` and ``gather`` at BERT-base's shapes, PyTorch's
   (atomics) against the port's ``RowGather``, timed, each run twice;
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
12. the kernels line, then the result line.

Exits non-zero, with no result line, when there is no CUDA card, when the
port's sources are not beside this script, or when any phase fails.
"""
from __future__ import annotations

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


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


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
    from paddle_tpu_torch.core import cuda_build
    names = list(cuda_build.SOURCES)
    t0 = time.perf_counter()
    paths = cuda_build.build(names)
    seconds = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in cuda_build.build_logs.get(n, "").splitlines()
                 if "registers" in ln or "spill" in ln] for n in names}
    emit("build", kernels=names, seconds=seconds,
         libraries=[os.path.relpath(p, REPO) for p in paths.values()], ptxas=ptxas)
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
    # (B, H, S, D, dtype, bias, causal, dropout); the first is the training path's. The
    # bf16 backward runs its fused variant at S <= 128 and its split one beyond (S 256,
    # 512 and the ragged 200)
    cases = [(128, 12, 128, 64, "bfloat16", True, False, p),
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
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    mode; fused_attention keeps its in-kernel dropout."""
    for op in program.global_block().ops:
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
    return float(loss[0]), ups


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
    from torch.profiler import ProfilerActivity, profile
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pred.run(requests[0])
        torch.cuda.synchronize()
    counted = {fn.__name__: fn.launches - n for fn, n in before.items() if fn.launches != n}
    traced = sum(e.count for e in prof.key_averages() if kernel_name in e.key)
    replay = dict(counters=counted, profiler_kernels={kernel_name: traced})
    del eager
    r = dict(requests=[dict(batch=B, seq=S, graph_ms=a * 1e3, eager_ms=b * 1e3)
                       for (B, S), a, b in zip(BERT_REQUESTS, lat, eager_lat)],
             bit_equal_to_eager=same,
             profile={f"{B}x{S}": v for (B, S), v in by_shape.items()},
             graphs=_graphs_held(pred), one_replay=replay)
    emit(f"{label}_graph_vs_eager", **r)
    if not all(same):
        raise SystemExit(f"{label}: graph-replayed outputs differ from the eager run: {same}")
    if traced != counted.get(counter):
        raise SystemExit(f"{label}: one replay ran {traced} {kernel_name} kernels (profiler) "
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
    from paddle_tpu_torch.tools.train_profile import (LR, MASKS_PER_SEQ, SEQ, build_pretrain,
                                                      build_resnet50)
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
    f32), with the program's attrs."""
    from paddle_tpu_torch.core.registry import torch_dtype
    blk = program.global_block()
    ops = [op for op in blk.ops if op.type == kind]
    lr = torch.full((1,), 1e-4 if kind == "adam" else 0.1, device="cuda")
    ins_list = []
    for op in ops:
        pv = blk.var(op.input("Param")[0])
        dt, shape = torch_dtype(pv.dtype), tuple(pv.shape)
        rnd = lambda scale: torch.randn(shape, generator=gen, device="cuda") * scale
        ins = {"Param": [rnd(0.05).to(dt)], "Grad": [rnd(1e-3).to(dt)], "LearningRate": [lr]}
        if kind == "adam":
            ins.update(Moment1=[rnd(1e-3)], Moment2=[rnd(1e-3).square()],
                       Beta1Pow=[torch.full((1,), 0.9 ** 3, device="cuda")],
                       Beta2Pow=[torch.full((1,), 0.999 ** 3, device="cuda")])
        else:
            ins["Velocity"] = [rnd(1e-3)]
        ins_list.append(ins)
    return dict(ops[0].attrs), ins_list


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


def phase_multi_tensor(torch, programs):
    """multi_tensor_update over each model's parameter list against the
    per-op lowerings on the card (bit for bit), with times, the bound and
    PyTorch's fused optimizers as yardsticks."""
    from paddle_tpu_torch.ops.multi_tensor import multi_tensor_update, update_plain
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    results = []
    for model, program, kind in programs:
        attrs, ins_list = _update_inputs(torch, program, kind, gen)
        # the update is in place: the kernel twice and the per-op lowerings, each
        # on its own copy of the inputs
        copies = [[{s: [t.clone() for t in v] for s, v in ins.items()} for ins in ins_list]
                  for _ in range(3)]
        outs = multi_tensor_update(kind, attrs, copies[0])
        again = multi_tensor_update(kind, attrs, copies[1])
        ref = update_plain(kind, attrs, copies[2])
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
        # device times from the profiler: the host work of a call (the work table
        # for ~200 tensors, ~2,000 launches for the per-op path) outlasts any
        # queue of sleep a CUDA-event window could put before it
        launches = _launch_times(torch, lambda: multi_tensor_update(kind, attrs, ins_list), 5)
        ms = sum(x["ms_per_launch"] * x["launches_per_call"] for x in launches
                 if "multi_tensor_kernel" in x["kernel"] or "beta_pow_kernel" in x["kernel"])
        table_copy_ms = sum(x["ms_per_launch"] * x["launches_per_call"] for x in launches
                            if "Memcpy" in x["kernel"])
        plain = _breakdown("update_plain", None, _launch_times(
            torch, lambda: update_plain(kind, attrs, ins_list), 3))
        plain_ms, plain_launches = plain["device_ms_per_call"], plain["launches_per_call"]
        wall_ms = _wall_ms(torch, lambda: multi_tensor_update(kind, attrs, ins_list))
        host_ms = _host_ms(torch, lambda: multi_tensor_update(kind, attrs, ins_list))
        plain_wall_ms = _wall_ms(torch, lambda: update_plain(kind, attrs, ins_list))
        # bytes: read p, g and the state, write p and the state (the scalars are noise)
        state = 2 if kind == "adam" else 1
        nbytes = sum(ins["Param"][0].numel() * (2 * ins["Param"][0].element_size()
                                                + ins["Grad"][0].element_size() + 8 * state)
                     for ins in ins_list)
        n = sum(ins["Param"][0].numel() for ins in ins_list)
        # yardstick: PyTorch's fused optimizer on f32 copies (its kernel takes one dtype
        # for a parameter and its state); Paddle's Adam adds eps to sqrt(v) after the
        # bias correction folds into lr, so the bits differ from PyTorch's anyway
        ps, gs, ms_, vs = ([ins[k][0].float().clone() for ins in ins_list]
                           for k in ("Param", "Grad", "Moment1" if kind == "adam" else "Velocity",
                                     "Moment2" if kind == "adam" else "Velocity"))
        library, library_ms, library_error = None, None, None
        try:
            if kind == "adam":
                library = "torch._fused_adam_ (f32 copies)"
                steps = [torch.ones((), device="cuda") for _ in ps]
                fn = lambda: torch._fused_adam_(ps, gs, ms_, vs, [], steps, lr=1e-4,
                                                beta1=attrs["beta1"], beta2=attrs["beta2"],
                                                weight_decay=0.0, eps=attrs["epsilon"],
                                                amsgrad=False, maximize=False)
            else:
                library = "torch._fused_sgd_ (f32 copies)"
                fn = lambda: torch._fused_sgd_(ps, gs, ms_, weight_decay=0.0,
                                               momentum=attrs["mu"], lr=0.1, dampening=0.0,
                                               nesterov=bool(attrs["use_nesterov"]),
                                               maximize=False, is_first_step=False)
            library_ms = _breakdown(library, None, _launch_times(torch, fn, 5))[
                "device_ms_per_call"]
        except (RuntimeError, TypeError) as e:      # a yardstick only: record why
            library_error = f"{type(e).__name__}: {e}"[:200]
        del ps, gs, ms_, vs
        r = dict(model=model, kind=kind, attrs=attrs, tensors=len(ins_list), elements=n,
                 param_dtypes=sorted({str(ins["Param"][0].dtype)[6:] for ins in ins_list}),
                 in_place=in_place, bit_exact=exact, max_ulp=ulp, max_abs_err=err,
                 ok=exact and finite and ms > 0,
                 ms=ms, table_copy_ms=table_copy_ms, plain_ms=plain_ms,
                 plain_launches_per_call=plain_launches, wall_ms=wall_ms, host_ms=host_ms,
                 plain_wall_ms=plain_wall_ms,
                 bytes=nbytes,
                 bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                 library=library, library_ms=library_ms, library_error=library_error)
        emit("kernel_vs_plain", kernel="multi_tensor_update", **r)
        results.append(r)
        del ins_list
        torch.cuda.empty_cache()
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise SystemExit(f"multi_tensor_update is not bit-exact to the per-op lowerings: {bad}")
    return results


# BERT-base's hidden dropout: [B * S, 768] at B128 S128, p 0.1
DROPOUT_SHAPE, DROPOUT_P = (128 * 128, 768), 0.1
CAPTURED_STEPS = 5           # steps held graph against eager
TIMED_STEPS = 6              # steps timed on each path (after the held ones)
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
    in both implementations, in f32, at a ragged size, on an unaligned view
    (the one-element path) and at p 0 and 1; at the main shape its time, the
    plain version's, ``F.dropout``'s (the library yardstick: another RNG,
    the same work) and the bound (read X, write Out and Mask)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import dropout as dmod
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 12)
    # (shape, dtype, upscale, p, element offset)
    cases = [(DROPOUT_SHAPE, "bfloat16", True, DROPOUT_P, 0),
             (DROPOUT_SHAPE, "bfloat16", False, DROPOUT_P, 0),
             ((4096, 768), "float32", True, DROPOUT_P, 0),
             ((1001, 77), "bfloat16", True, 0.3, 0),
             ((4096, 768), "bfloat16", True, DROPOUT_P, 1),
             ((333,), "float32", True, 1.0, 0),
             ((333,), "bfloat16", False, 0.0, 0)]
    hbm_card = _hbm_from_card(torch)
    results = []
    for i, (shape, dt, upscale, p, off) in enumerate(cases):
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
        if i < 2:
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
    """The gradients of lookup_table_v2 and gather at BERT-base's shapes, on
    the card: PyTorch's (``F.embedding`` / ``index_select`` backward, which
    add with atomics) against the port's ``RowGather`` (sorted accumulation):
    device time of the backward alone, and whether two runs give the same
    bits."""
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
    """Step ms of each of TIMED_STEPS steps (fetching the loss as numpy), the
    peak of allocated memory over them and the graph pools, then 3 steps
    under the profiler. The executor is closed at the end."""
    from paddle_tpu_torch.tools.train_profile import profile_steps
    exe = pt.Executor()
    exe._use_graphs, exe._free_dead = graphs_on, free_dead
    scope = pt.Scope()
    for n, t in init.items():
        scope.set_var(n, t.clone())
    main._rng_run_counter = 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times = []
    with pt.scope_guard(scope):
        for _ in range(TIMED_STEPS):
            t0 = time.perf_counter()
            exe.run(main, feed=feed, fetch_list=[loss])
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 1e9
        pools = _graph_pools(exe)
        prof = profile_steps(torch, exe, main, feed, loss, 3)
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
                by_kind=prof["by_kind"])


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


def _captured_model(torch, pt, label, main, startup, feed, loss, expected, extra_fetch):
    """Graph executor against the eager executor (``_use_graphs = False``) on
    one model: CAPTURED_STEPS steps from the same state, losses and every
    state tensor compared bit for bit, the eager path against itself (its
    run-to-run noise); ``run_fused`` (K = FUSED_K) against K ``run`` calls;
    then each path timed and profiled, and the memory before and after
    freeing dead intermediates."""
    from paddle_tpu_torch.core import cuda_build
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt.Executor().run(startup)
        init = {n: scope.find_var(n).clone() for n, v in main.global_block().vars.items()
                if v.persistable and scope.find_var(n) is not None}
    del scope
    fetch = [loss] + extra_fetch
    runs, launches = {}, {}
    for path in ("graph", "eager", "eager_again"):
        exe = pt.Executor()
        exe._use_graphs = path == "graph"
        for fn in cuda_build.COUNTED:
            fn.launches = 0
        outs, state, scope = _steps(pt, exe, main, feed, fetch, init, CAPTURED_STEPS)
        torch.cuda.synchronize()
        launches[path] = {fn.__name__: fn.launches for fn in cuda_build.COUNTED if fn.launches}
        runs[path] = (outs, {n: t.clone() for n, t in state.items()})
        if path == "graph":
            pools = _graph_pools(exe)
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
    if extra_fetch:                     # a dropout op's Mask at steps 1 and 2
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
    if extra_fetch and not (r["mask_step1_equal"] and r["mask_step2_equal"]
                            and r["mask_differs_between_steps"]):
        raise SystemExit(f"{label}: the dropout masks do not follow the counter: {r}")
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

    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.tools.train_profile import (LR, MASKS_PER_SEQ, SEQ, build_pretrain,
                                                      build_resnet50)

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
    mres = phase_multi_tensor(torch, [("bert-base", bert_prog, "adam"),
                                      ("resnet50", resnet[0], "momentum")])
    del bert_prog
    scratch = os.path.join(REPO, "build")      # git-ignored
    os.makedirs(scratch, exist_ok=True)
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

    serve_case = next(r for r in kres if r["dtype"] == "bfloat16" and r["shape"][2] == 512
                      and r["bias"] and not r["causal"])
    train_fwd, train_bwd = tres[0]             # B128 H12 S128 D64 bf16, bias, dropout 0.1
    fwd_err = max([r["max_abs_err"] for r in kres if r["dtype"] == "bfloat16"]
                  + [f["max_abs_err"] for f, _ in tres if f["dtype"] == "bfloat16"])
    bwd_err = max(b["max_abs_err"] for _, b in tres if b["dtype"] == "bfloat16")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    conv_case = next(r for r in cres if r["shape"] == [401408, 64, 256])
    conv_path = [r for r in cres if r["launches_per_forward_pass"]]
    int8_case = next(r for r in ires if r["shape"] == [4096, 768, 3072])
    mt_bert, mt_res = mres
    drop_case = dres[0]                        # [16384, 768] bf16, upscale_in_train, p 0.1
    drop_launches = cap_bert["launches"]["graph"]["dropout_fwd"]
    no_library = ("no single PyTorch call computes this function; matmul_ms is a bf16 "
                  "torch.matmul of the same shape, for context")
    print(smi.splitlines()[0] if smi else "nvidia-smi printed nothing", flush=True)
    print(json.dumps({"kernels": [
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_attn_fwd.cu",
         "replaces": "paddle_tpu/ops/pallas_attention.py:227",
         "launches": (serve_launches["flash_attn_fwd"] + int8_launches["flash_attn_fwd"]
                      + train_launches["flash_attn_fwd"]),
         "launches_by_path": {"serving": serve_launches["flash_attn_fwd"],
                              "int8_serving": int8_launches["flash_attn_fwd"],
                              "training": train_launches["flash_attn_fwd"]},
         "max_abs_err": fwd_err, **{k: train_fwd[k] for k in keys},
         "shape": "B128 H12 S128 D64 bf16, bias, dropout 0.1, LSE (the training path)",
         "serving": {**{k: serve_case[k] for k in keys},
                     "shape": "B8 H12 S512 D64 bf16 with bias, no dropout, no LSE"}},
        {"name": "flash_attn_bwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_attn_bwd.cu",
         "replaces": "paddle_tpu/ops/pallas_attention.py:260",
         "launches": train_launches["flash_attn_bwd"],
         "launches_by_path": {"training": train_launches["flash_attn_bwd"]},
         "max_abs_err": bwd_err,
         **{k: train_bwd[k] for k in keys},
         "shape": "B128 H12 S128 D64 bf16, bias, dropout 0.1 (the training path)"},
        {"name": "fused_conv1x1_bn_fwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/conv1x1_bn.cu",
         "replaces": "paddle_tpu/ops/pallas_conv_bn.py:124",
         "launches": resnet_launches["fused_conv1x1_bn_fwd"],
         "launches_by_path": {"resnet50_training": resnet_launches["fused_conv1x1_bn_fwd"]},
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
         "launches": drop_launches,
         "launches_by_path": {"captured_training": drop_launches},
         "max_abs_err": max(r["max_abs_err"] for r in dres),
         **{k: drop_case[k] for k in keys}, "library": drop_case["library"],
         "shape": "[16384, 768] bf16, upscale_in_train, p 0.1 (BERT-base's hidden dropout)"},
        {"name": "multi_tensor_update", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/multi_tensor_update.cu", "in_place": True,
         "replaces": "paddle_tpu/compiler.py:94",
         "replaces_note": ("no Pallas kernel: fuse_all_optimizer_ops, under which XLA "
                           "updates every parameter inside the one compiled step"),
         "launches": (train_launches["multi_tensor_update"]
                      + resnet_launches["multi_tensor_update"]),
         "launches_by_path": {"training": train_launches["multi_tensor_update"],
                              "resnet50_training": resnet_launches["multi_tensor_update"]},
         "max_abs_err": max(r["max_abs_err"] for r in mres),
         **{k: mt_bert[k] for k in keys}, "library": mt_bert["library"],
         "shape": (f"BERT-base's {mt_bert['tensors']} Adam parameters, "
                   f"{mt_bert['elements']} elements, bf16 and f32, f32 moments"),
         "resnet50": {**{k: mt_res[k] for k in keys}, "library": mt_res["library"],
                      "shape": (f"ResNet-50's {mt_res['tensors']} Momentum parameters, "
                                f"{mt_res['elements']} elements, bf16, f32 velocity")}}],
        "captured_step_ms": {
            name: {p: r["paths"][p]["step_ms_median_warm"] for p in ("graph", "eager")}
            for name, r in (("bert_base", cap_bert), ("resnet50", cap_resnet))},
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
