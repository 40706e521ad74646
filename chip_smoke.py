#!/usr/bin/env python3
"""Serve and train BERT-base through the PyTorch/CUDA port on one NVIDIA
GPU, and hold its CUDA kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA. Phases, each printing JSON lines:

1. device: the card, its power limit, the toolchain;
2. build: compile every kernel of ``paddle_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel);
3. kernel vs plain: each kernel on the card at the main paths' shapes,
   against its plain version on the same inputs, with times (CUDA events,
   median of 25 single launches queued behind a busy GPU), the PyTorch
   library call that computes the same function, and the card's bound:
   ``flash_attn_fwd`` as serving calls it, ``flash_attn_fwd`` with dropout
   and the LSE as training calls it, and ``flash_attn_bwd``;
4. serving path: build BERT-base (L12 H768 A12, bf16, random weights from a
   seed) with the port's DSL, run its startup program on the card, save it
   with ``save_inference_model``, load it into a ``Predictor`` and answer
   4 requests of 8 x 128 tokens and 2 of 8 x 512 with ragged masks; checks
   that every kernel of the path launched (``flash_attn_fwd``: 12 per
   request), that the outputs are finite, and that the first request
   agrees with the plain attention on the card and with the CPU
   Predictor (the plain path);
5. training path: BERT-base pretraining at bench.py's configuration (batch
   128, S 128, 2560 masked positions, bf16, dropout 0.1, Adam 1e-4, seed 0)
   built with ``append_backward`` and ``Adam.minimize``, startup on the
   card, a few steps on one repeated batch; checks the launches per step
   (``flash_attn_fwd`` 24: 12 forward ops and their 12 recomputes inside
   ``fused_attention_grad``; ``flash_attn_bwd`` 12), a finite loss that
   falls, and step 1 against two references from the same weights: the
   card's ``attn_impl="composed"`` program (plain matmul/softmax
   attention) and, at batch 2 with the same attention-dropout masks, the
   CPU port;
6. the kernels line, then the result line.

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
    names = sorted(f[:-3] for f in os.listdir(cuda_build.CSRC) if f.endswith(".cu"))
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
        torch.cuda.synchronize()
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
        ok = finite and err <= ATOL[dt]
        r = dict(shape=[B, H, S, D], dtype=dt, bias=has_bias, causal=causal,
                 max_abs_err=err, atol=ATOL[dt], ok=ok, ms=ms, plain_ms=plain_ms,
                 library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
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
                                                      flash_attn_bwd, flash_attn_fwd)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    p = ATTN_DROPOUT
    # (B, H, S, D, dtype, bias, causal, dropout); the first is the training path's
    cases = [(128, 12, 128, 64, "bfloat16", True, False, p),
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
        torch.cuda.synchronize()
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
        fwd_ok = finite and fwd_err <= fwd_tol and lse_err <= LSE_ATOL
        bwd_ok = finite and all(r["max_abs_err"] <= BWD_REL[dt] * r["max_abs_ref"]
                                for r in bwd.values())
        shape = dict(shape=[B, H, S, D], dtype=dt, bias=has_bias, causal=causal, dropout=drop)
        r_fwd = dict(shape, max_abs_err=fwd_err, atol=fwd_tol, lse_max_abs_err=lse_err,
                     lse_atol=LSE_ATOL, ok=fwd_ok, ms=fwd_ms, plain_ms=fwd_plain_ms,
                     library_ms=fwd_lib_ms, bound_ms=fb, bound_by=fby)
        r_bwd = dict(shape, grads=bwd, rel_tol=BWD_REL[dt], ok=bwd_ok,
                     max_abs_err=max(r["max_abs_err"] for r in bwd.values()), ms=bwd_ms,
                     plain_ms=bwd_plain_ms, library_ms=bwd_lib_ms, bound_ms=bb, bound_by=bby)
        emit("kernel_vs_plain", kernel="flash_attn_fwd+dropout+lse", **r_fwd)
        emit("kernel_vs_plain", kernel="flash_attn_bwd", **r_bwd)
        results.append((r_fwd, r_bwd))
        del q, k, v, bias, do, o, lse, dq, dk, dv
    bad = [r for pair in results for r in pair if not r["ok"]]
    if bad:
        raise SystemExit(f"training kernels disagree with their plain versions: {bad}")
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


def phase_train_path(torch):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import flash_attention
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

        torch.cuda.reset_peak_memory_stats()
        flash_attention.flash_attn_fwd.launches = 0
        flash_attention.flash_attn_bwd.launches = 0
        losses, step_s = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(float(exe.run(main, feed=feed, fetch_list=[total])[0][0]))
            step_s.append(time.perf_counter() - t0)
        launches = {"flash_attn_fwd": flash_attention.flash_attn_fwd.launches,
                    "flash_attn_bwd": flash_attention.flash_attn_bwd.launches}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del scope
    expected = {"flash_attn_fwd": 2 * cfg.n_layers * TRAIN_STEPS,
                "flash_attn_bwd": cfg.n_layers * TRAIN_STEPS}
    warm = sorted(step_s[1:])
    step_ms = warm[len(warm) // 2] * 1e3
    model = (f"bert-base pretrain L{cfg.n_layers} H{cfg.hidden} A{cfg.n_heads} "
             f"FFN{cfg.ffn_hidden} vocab{cfg.vocab_size} {cfg.dtype} B{BATCH} S{SEQ} "
             f"masks {BATCH * MASKS_PER_SEQ} dropout {cfg.dropout} Adam({LR})")
    emit("train_path", model=model, params=n_params, build_s=build_s, startup_s=startup_s,
         losses=losses, step_ms=[t * 1e3 for t in step_s], step_ms_median_warm=step_ms,
         sequences_per_s=BATCH / (step_ms / 1e3), peak_memory_gb=peak_gb,
         launches=launches, expected_launches=expected,
         launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()})
    if launches != expected:
        raise SystemExit(f"training launches {launches}, expected {expected}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise SystemExit(f"training loss is not finite and falling: {losses}")

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
    if flash_attention.flash_attn_fwd.launches != 2 * cfg.n_layers:
        raise SystemExit("the batch-2 card step did not run the attention kernels")
    cpu = dict(_gaps(card_run, cpu_run), cpu_seconds=cpu_s)
    emit("train_step1_gaps", vs_card_composed=composed, vs_cpu_port_batch2=cpu,
         loss_rel_limit=TRAIN_LOSS_REL, update_rel_l1_limit=TRAIN_UPDATE_REL)
    for name, g in (("card composed", composed), ("CPU port", cpu)):
        if not (g["loss_rel_gap"] <= TRAIN_LOSS_REL
                and g["update_rel_l1_gap"] <= TRAIN_UPDATE_REL):
            raise SystemExit(f"training step 1 against the {name}: gaps {g} exceed the limits")
    return launches, step_ms


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
    return launches


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

    t_start = time.perf_counter()
    smi = phase_device(torch)
    phase_build()
    kres = phase_kernels(torch)
    tres = phase_train_kernels(torch)
    scratch = os.path.join(REPO, "build")      # git-ignored
    os.makedirs(scratch, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    try:
        serve_launches = phase_main_path(torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    train_launches, step_ms = phase_train_path(torch)

    serve_case = next(r for r in kres if r["dtype"] == "bfloat16" and r["shape"][2] == 512
                      and r["bias"] and not r["causal"])
    train_fwd, train_bwd = tres[0]             # B128 H12 S128 D64 bf16, bias, dropout 0.1
    fwd_err = max([r["max_abs_err"] for r in kres if r["dtype"] == "bfloat16"]
                  + [f["max_abs_err"] for f, _ in tres if f["dtype"] == "bfloat16"])
    bwd_err = max(b["max_abs_err"] for _, b in tres if b["dtype"] == "bfloat16")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi.splitlines()[0] if smi else "nvidia-smi printed nothing", flush=True)
    print(json.dumps({"kernels": [
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_attn_fwd.cu",
         "replaces": "paddle_tpu/ops/pallas_attention.py:227",
         "launches": serve_launches["flash_attn_fwd"] + train_launches["flash_attn_fwd"],
         "launches_by_path": {"serving": serve_launches["flash_attn_fwd"],
                              "training": train_launches["flash_attn_fwd"]},
         "max_abs_err": fwd_err, **{k: train_fwd[k] for k in keys},
         "shape": "B128 H12 S128 D64 bf16, bias, dropout 0.1, LSE (the training path)",
         "serving": {**{k: serve_case[k] for k in keys},
                     "shape": "B8 H12 S512 D64 bf16 with bias, no dropout, no LSE"}},
        {"name": "flash_attn_bwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_attn_bwd.cu",
         "replaces": "paddle_tpu/ops/pallas_attention.py:260",
         "launches": train_launches["flash_attn_bwd"], "max_abs_err": bwd_err,
         **{k: train_bwd[k] for k in keys},
         "shape": "B128 H12 S128 D64 bf16, bias, dropout 0.1 (the training path)"}],
        "train_step_ms": step_ms, "seconds": time.perf_counter() - t_start}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
