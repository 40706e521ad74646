"""The host time of a warm captured ``Executor.run`` with nothing armed.

    python3 paddle_tpu_torch/tools/run_overhead.py [--repo DIR] [--steps N]

Imports ``paddle_tpu_torch`` from ``DIR`` (default: the checkout this file
lies in), so that two trees can be compared on one card, each in a process
of its own. Builds two host-bound training steps with the tree's own
``tools/train_profile.py``: the MNIST MLP (SGD, batch 256) and DeepFM (Adam
and ``auc``, batch 4096), their feeds already on the card. Each is run to
its CUDA graph, then ``--steps`` warm runs with ``return_numpy=False`` and
the loss fetched, three times over: ``host_us`` is
the mean host time of one ``run`` call (no sync inside the loop), ``step_ms``
the wall time per step of the whole loop, the card synchronised at its end.
``PADDLE_TPU_OBS`` must be unset and no flag set. Prints one JSON line per
model. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _measure(torch, pt, main, startup, loss, feed, steps: int, reps: int = 3) -> dict:
    exe = pt.Executor()
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe.run(startup)
        for _ in range(3):      # the first run, the capture, one replay
            exe.run(main, feed=feed, fetch_list=[loss], return_numpy=False)
        torch.cuda.synchronize()
        host, wall = [], []
        for _ in range(reps):
            spent = 0.0
            t0 = time.perf_counter()
            for _ in range(steps):
                t = time.perf_counter()
                exe.run(main, feed=feed, fetch_list=[loss], return_numpy=False)
                spent += time.perf_counter() - t
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) / steps)
            host.append(spent / steps)
    exe.close()
    return {"host_us": [round(h * 1e6, 2) for h in host],
            "step_ms": [round(w * 1e3, 4) for w in wall],
            "host_us_min": round(min(host) * 1e6, 2), "step_ms_min": round(min(wall) * 1e3, 4)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=REPO)
    ap.add_argument("--steps", type=int, default=500)
    args = ap.parse_args(argv)
    if os.environ.get("PADDLE_TPU_OBS"):
        raise SystemExit("unset PADDLE_TPU_OBS: this measures the unarmed path")
    sys.path.insert(0, os.path.abspath(args.repo))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.tools import train_profile as tp
    rng = np.random.RandomState(0)
    cases = (("mnist_mlp", tp.build_mnist, tp.mnist_feed),
             ("deepfm", tp.build_deepfm, tp.deepfm_feed))
    for name, build, make_feed in cases:
        main_p, startup, loss = build()[:3]
        feed = {k: torch.as_tensor(v, device="cuda") for k, v in make_feed(rng).items()}
        r = _measure(torch, pt, main_p, startup, loss, feed, args.steps)
        print(json.dumps({"run_overhead": name, "repo": os.path.abspath(args.repo),
                          "steps": args.steps, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
