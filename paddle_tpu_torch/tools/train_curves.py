"""Loss curves of BERT-base pretraining on the card, with the attention
kernels and with the plain composed attention, from the same weights.

    python3 -m paddle_tpu_torch.tools.train_curves [steps]

Builds bench.py's pretraining configuration (see ``train_profile``) three
ways -- fused attention (the CUDA kernels) with dropout 0.1, fused with
dropout 0, and ``attn_impl="composed"`` (matmul/softmax ops) with dropout
0 -- loads one startup state into each, runs ``steps`` steps (default 10)
on one repeated batch and prints each run's losses as a JSON line. The two
dropout-0 curves differ only by the attention's arithmetic, so they show
whether a feature of the curve comes from the kernels or from the model and
optimizer. Needs a CUDA card.
"""
from __future__ import annotations

import json
import sys

import numpy as np


def main(steps=10):
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("train_curves: no CUDA device")
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.tools.train_profile import (BATCH, MASKS_PER_SEQ, SEED, SEQ,
                                                      build_pretrain, pretrain_feed)
    feed = pretrain_feed(np.random.RandomState(SEED), bert.BertConfig(), BATCH, SEQ,
                         MASKS_PER_SEQ)
    init = None
    for impl, dropout in (("auto", 0.1), ("auto", 0.0), ("composed", 0.0)):
        cfg = bert.BertConfig(dtype="bfloat16", dropout=dropout, attn_impl=impl)
        main_prog, startup, total, _ = build_pretrain(cfg, BATCH, SEQ, MASKS_PER_SEQ)
        scope = pt.Scope()
        exe = pt.Executor()
        with pt.scope_guard(scope):
            if init is None:
                exe.run(startup)
                init = {n: scope.find_var(n).clone()
                        for n, v in main_prog.global_block().vars.items() if v.persistable}
            else:
                for n, t in init.items():
                    scope.set_var(n, t.clone())
            losses = [float(exe.run(main_prog, feed=feed, fetch_list=[total])[0][0])
                      for _ in range(steps)]
        print(json.dumps({"attn_impl": impl, "dropout": dropout, "losses": losses,
                          "gpu": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
