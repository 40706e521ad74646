#!/usr/bin/env python3
"""Serve BERT-base through the PyTorch/CUDA port on one NVIDIA GPU, and hold
its CUDA kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA. Phases, each printing one JSON line:

1. device: the card, its power limit, the toolchain;
2. build: compile every kernel of ``paddle_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel);
3. kernel vs plain: each kernel on the card at the main path's shapes,
   against its plain version on the same inputs, with times (CUDA events,
   median of 25 single launches queued behind a busy GPU), the PyTorch
   library call that computes the same function, and the card's bound;
4. main path: build BERT-base (L12 H768 A12, bf16, random weights from a
   seed) with the port's DSL, run its startup program on the card, save it
   with ``save_inference_model``, load it into a ``Predictor`` and answer
   4 requests of 8 x 128 tokens and 2 of 8 x 512 with ragged masks; checks
   that every kernel of the path launched (``flash_attn_fwd``: 12 per
   request), that the outputs are finite, and that the first request
   agrees with the plain attention on the card and with the CPU
   Predictor (the plain path);
5. the kernels line, then the result line.

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
# main path, bf16 end to end over 12 layers, first request. Two gaps are held:
# the kernel against the plain version, both on the card (the kernel rounds P
# before normalising, the plain version after), and the card's plain path
# against the CPU's (cuBLAS and the CPU sum the bf16 matmuls in other orders).
# Each rounding moves an element by about one bf16 ulp, and such moves add up
# over the layers: the limits are 2 ulps of the largest outputs (0.0625 at
# |x| in [8, 16)) for the maximum and 2 ulps of typical outputs (0.0078 at
# |x| in [1, 2)) for the mean.
E2E_MAX_ABS, E2E_MEAN_ABS = 0.125, 1.6e-2

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


def phase_main_path(torch, workdir):
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

    phase_device(torch)
    phase_build()
    kres = phase_kernels(torch)
    scratch = os.path.join(REPO, "build")      # git-ignored
    os.makedirs(scratch, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    try:
        launches = phase_main_path(torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    main_case = next(r for r in kres if r["dtype"] == "bfloat16" and r["shape"][2] == 512
                     and r["bias"] and not r["causal"])
    bf16_err = max(r["max_abs_err"] for r in kres if r["dtype"] == "bfloat16")
    print(json.dumps({"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas_attention.py:227",
        "launches": launches["flash_attn_fwd"], "max_abs_err": bf16_err,
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "shape": "B8 H12 S512 D64 bf16 with bias"}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
