"""How many device records a short ``torch.profiler`` window keeps, with and
without ``train_profile.TRACE_MARGIN_S`` of idle time on either side of its
work.

Each round traces one replay of a CUDA graph of ``KERNELS`` elementwise
kernels twice, once starting the replay as the window opens and once inside
``train_profile.traced``, then runs a few large matmuls and waits half a
second, for ``--seconds`` seconds. Prints one JSON line: for each margin the
windows traced, how many came back short, and the first few (seconds into
the run, records kept).

    python3 -m paddle_tpu_torch.tools.trace_probe [--seconds 330]
"""
from __future__ import annotations

import argparse
import json
import time

KERNELS = 70


def main():
    import torch
    from torch.profiler import ProfilerActivity
    from .train_profile import TRACE_MARGIN_S, traced
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=330.0)
    args = ap.parse_args()
    x = torch.rand(4096, device="cuda") + 1.0
    a = torch.randn(4096, 4096, device="cuda")

    def step():
        for _ in range(KERNELS):
            x.add_(1.0)

    step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    torch.cuda.synchronize()

    def window(margin):
        with traced([ProfilerActivity.CUDA], margin) as prof:
            graph.replay()
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages() if "elementwise" in e.key)

    rows = {0.0: [], TRACE_MARGIN_S: []}
    t0 = time.time()
    while time.time() - t0 < args.seconds:
        for margin, kept in rows.items():
            kept.append((round(time.time() - t0, 1), window(margin)))
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()
        time.sleep(0.5)
    print(json.dumps({"gpu": torch.cuda.get_device_name(0), "kernels": KERNELS,
                      "margins": {str(m): {"windows": len(v),
                                           "short": sum(n != KERNELS for _, n in v),
                                           "first_short": [r for r in v if r[1] != KERNELS][:10]}
                                  for m, v in rows.items()}}), flush=True)


if __name__ == "__main__":
    main()
