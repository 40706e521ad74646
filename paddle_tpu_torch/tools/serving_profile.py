"""Where a BERT-base serving request spends its time on the card.

    python3 -m paddle_tpu_torch.tools.serving_profile          # bf16
    python3 -m paddle_tpu_torch.tools.serving_profile int8     # int8 weights

Builds the BERT-base encoder (L12 H768 A12, bf16, random weights from a
seed) with the port's DSL, saves it with ``save_inference_model`` into the
git-ignored ``build/`` directory, loads it into a ``Predictor`` on the card,
and for each request shape (batch 8 x S 128 and 8 x 512) traces warm
requests (3 each) with ``torch.profiler``. Prints one JSON line per shape: wall time
per request, device busy time (the sum of the device activities, one
stream), the idle share, kernel launches per request and the top kernels by
device time. With ``int8`` the weights are quantized with
``quantize_weights(int8_compute=True)`` before saving, so every fc runs the
CUDA int8 matmul kernel. Needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FEEDS = (("src_ids", "int64"), ("pos_ids", "int64"), ("sent_ids", "int64"),
         ("input_mask", "float32"))


def save_bert_encoder(model_dir, cfg, seed=0, place=None, int8_dir=None):
    """Build the BERT encoder with the port's DSL, run its startup program
    (on ``place``; None is the card) and save it for inference. With
    ``int8_dir``, also quantize the same weights (``quantize_weights(...,
    int8_compute=True)``) and save that model there."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import bert
    main, startup = pt.Program(), pt.Program()
    main.random_seed = seed
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        feeds = [pt.data(n, [cfg.max_seq_len], dt) for n, dt in FEEDS]
        enc = bert.encoder(*feeds, cfg)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe = pt.Executor(place)
        exe.run(startup)
        pt.io.save_inference_model(model_dir, [f.name for f in feeds], [enc], exe,
                                   main_program=main)
        if int8_dir is not None:
            from paddle_tpu_torch.contrib.quantize import quantize_weights
            quantize_weights(main, scope, int8_compute=True)
            pt.io.save_inference_model(int8_dir, [f.name for f in feeds], [enc], exe,
                                       main_program=main)


def bert_feed(rng, B, S, vocab):
    """One request: random ids, positions, two segments and a ragged mask
    (each row a random valid length in [S/4, S])."""
    lens = rng.randint(S // 4, S + 1, size=B)
    valid = np.arange(S)[None, :] < lens[:, None]
    sent = (np.arange(S)[None, :] >= (lens // 2)[:, None]) & valid
    return {"src_ids": rng.randint(0, vocab, (B, S)).astype("int64"),
            "pos_ids": np.tile(np.arange(S), (B, 1)).astype("int64"),
            "sent_ids": sent.astype("int64"),
            "input_mask": valid.astype("float32")}


def profile_shape(torch, pred, feed, n_requests):
    from torch.profiler import ProfilerActivity
    from .train_profile import traced
    pred.run(feed)
    torch.cuda.synchronize()
    with traced([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_requests):
            pred.run(feed)
        wall = (time.perf_counter() - t0) / n_requests
    device = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0 and e.cpu_time_total == 0:   # device activities carry no CPU time
            device.append((us / n_requests, e.count / n_requests, e.key))
    if not device:
        raise SystemExit("torch.profiler recorded no device activity: device busy "
                         "time not measured")
    device.sort(reverse=True)
    busy_ms = sum(us for us, _, _ in device) / 1e3
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1 - busy_ms / (wall * 1e3)),
            "device_activities_per_request": sum(c for _, c, _ in device),
            "top": [{"name": k[:90], "ms": us / 1e3, "per_request": c}
                    for us, c, k in device[:12]]}


def main():
    import sys
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("serving_profile: no CUDA device")
    int8 = sys.argv[1:] == ["int8"]
    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.models import bert
    cfg = bert.BertConfig(dtype="bfloat16")
    scratch = os.path.join(REPO, "build")
    os.makedirs(scratch, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="serving_profile_", dir=scratch)
    try:
        save_bert_encoder(os.path.join(workdir, "bert"), cfg,
                          int8_dir=os.path.join(workdir, "int8") if int8 else None)
        pred = Predictor(os.path.join(workdir, "int8" if int8 else "bert"))
        rng = np.random.RandomState(0)
        for B, S in ((8, 128), (8, 512)):
            r = profile_shape(torch, pred, bert_feed(rng, B, S, cfg.vocab_size), 3)
            kind = "int8 weights, bf16 activations" if int8 else "bf16"
            print(json.dumps({"profile": f"bert-base L{cfg.n_layers} {kind} B{B} S{S}",
                              "gpu": torch.cuda.get_device_name(0), **r}), flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
