"""Where a BERT-base pretraining step spends its time on the card.

    python3 -m paddle_tpu_torch.tools.train_profile

Builds the BERT-base pretraining program (L12 H768 A12, FFN 3072, vocab
30522, bf16, dropout 0.1, tied MLM decode) at the configuration of
``bench.py::bench_bert_base`` -- batch 128, S 128, 20 masked positions per
sequence, ``Adam(1e-4)``, seed 0 -- with the port's DSL, ``append_backward``
and ``Adam.minimize``; runs its startup program on the card, takes two warm
steps, then traces 3 steps with ``torch.profiler``. Prints one JSON line:
wall time per step, device busy time (the sum of the device activities, one
stream), the idle share, device activities per step, device time by kind
(the attention kernels, matmuls, copies, everything else) and the top
kernels by device time. Needs a CUDA card.

``build_pretrain`` and ``pretrain_feed`` are what ``chip_smoke.py`` drives.
"""
from __future__ import annotations

import json
import time

import numpy as np

#: bench.py::bench_bert_base's pretraining configuration
BATCH, SEQ, MASKS_PER_SEQ, LR, SEED = 128, 128, 20, 1e-4, 0
FEEDS = (("src_ids", "int64", "seq"), ("pos_ids", "int64", "seq"),
         ("sent_ids", "int64", "seq"), ("input_mask", "float32", "seq"),
         ("mask_pos", "int64", "masks"), ("mask_label", "int64", "masks"),
         ("nsp_label", "int64", "batch"))


def build_pretrain(cfg, batch, seq, n_masks, lr=LR, seed=SEED):
    """The pretraining Program at static shapes (batch x seq tokens, n_masks
    masked positions per sequence) with ``Adam(lr)``. Returns (main,
    startup, total_loss, params_grads)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import bert
    M = batch * n_masks
    shapes = {"seq": [batch, seq], "masks": [M, 1], "batch": [batch, 1]}
    main, startup = pt.Program(), pt.Program()
    main.random_seed = seed
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        ins = [pt.data(n, shapes[kind], dt, append_batch_size=False)
               for n, dt, kind in FEEDS]
        total, _, _ = bert.pretrain(*ins, cfg)
        _, params_grads = pt.optimizer.Adam(lr).minimize(total)
    return main, startup, total, params_grads


def pretrain_feed(rng, cfg, batch, seq, n_masks):
    """One batch, drawn as bench.py draws it: random ids, positions, random
    segments, a full mask, random masked positions and labels."""
    M = batch * n_masks
    return {"src_ids": rng.randint(0, cfg.vocab_size, (batch, seq)).astype("int64"),
            "pos_ids": np.tile(np.arange(seq, dtype="int64"), (batch, 1)),
            "sent_ids": rng.randint(0, 2, (batch, seq)).astype("int64"),
            "input_mask": np.ones((batch, seq), "float32"),
            "mask_pos": rng.randint(0, batch * seq, (M, 1)).astype("int64"),
            "mask_label": rng.randint(0, cfg.vocab_size, (M, 1)).astype("int64"),
            "nsp_label": rng.randint(0, 2, (batch, 1)).astype("int64")}


# device activity name -> kind, by the first pattern it contains
KINDS = (("attention kernels", ("flash_fwd", "bwd_dkdv", "bwd_dq", "delta_kernel")),
         ("matmul", ("nvjet", "gemm", "cutlass", "xmma")),
         ("copy", ("copy", "Memcpy", "Memset")))


def _kind(name):
    return next((k for k, pats in KINDS if any(p in name for p in pats)),
                "other (elementwise, reductions)")


def profile_steps(torch, exe, main, feed, total, n_steps):
    """Trace ``n_steps`` training steps; device time by activity name."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            exe.run(main, feed=feed, fetch_list=[total])   # numpy: the step is done
        wall = (time.perf_counter() - t0) / n_steps
    device = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0 and e.cpu_time_total == 0:   # device activities carry no CPU time
            device.append((us / n_steps, e.count / n_steps, e.key))
    if not device:
        raise SystemExit("torch.profiler recorded no device activity: device busy "
                         "time not measured")
    device.sort(reverse=True)
    busy_ms = sum(us for us, _, _ in device) / 1e3
    by_kind = {}
    for us, c, k in device:
        ms, n = by_kind.get(_kind(k), (0.0, 0.0))
        by_kind[_kind(k)] = (ms + us / 1e3, n + c)
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1 - busy_ms / (wall * 1e3)),
            "device_activities_per_step": sum(c for _, c, _ in device),
            "by_kind": {k: {"ms": ms, "per_step": n} for k, (ms, n) in by_kind.items()},
            "top": [{"name": k[:90], "ms": us / 1e3, "per_step": c}
                    for us, c, k in device[:15]]}


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("train_profile: no CUDA device")
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import bert
    cfg = bert.BertConfig(dtype="bfloat16")
    main_prog, startup, total, _ = build_pretrain(cfg, BATCH, SEQ, MASKS_PER_SEQ)
    feed = pretrain_feed(np.random.RandomState(SEED), cfg, BATCH, SEQ, MASKS_PER_SEQ)
    exe = pt.Executor()
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        for _ in range(2):
            exe.run(main_prog, feed=feed, fetch_list=[total])
        torch.cuda.synchronize()
        r = profile_steps(torch, exe, main_prog, feed, total, 3)
    print(json.dumps({"profile": f"bert-base pretrain L{cfg.n_layers} bf16 B{BATCH} S{SEQ} "
                                 f"masks {BATCH * MASKS_PER_SEQ} Adam",
                      "gpu": torch.cuda.get_device_name(0), **r}), flush=True)


if __name__ == "__main__":
    main()
