"""CLI: ``python -m paddle_tpu_torch.comm --selftest`` -- hermetic
self-check of the comm layer (quantizers, error feedback, planner
decompositions, wire-byte pricing, rewrite idempotence) on the CPU. No
device search, no tuning cache, no process group, no network.
"""
from __future__ import annotations

import argparse
import sys


def _check(failures, verbose, name, cond, detail=""):
    ok = bool(cond)
    if not ok:
        failures.append(name)
    if verbose or not ok:
        print(f"[comm-selftest] {'ok  ' if ok else 'FAIL'} {name}"
              + (f"  ({detail})" if detail and not ok else ""))
    return ok


def run_selftest(verbose: bool = False) -> int:
    import numpy as np

    from . import compress, cost, reshard, rewrite

    f = []

    # -- quantize/dequantize round trip -----------------------------------
    rs = np.random.RandomState(7)
    x = rs.randn(4096).astype("float32") * 3.0
    import torch
    q, s = compress.quantize_int8(torch.from_numpy(x))
    back = compress.dequantize_int8(q, s).numpy()
    amax = float(np.abs(x).max())
    _check(f, verbose, "int8 round-trip bound",
           float(np.abs(back - x).max()) <= amax / 254.0 + 1e-6,
           f"max err {np.abs(back - x).max():.3g} vs bound {amax / 254:.3g}")
    _check(f, verbose, "int8 zero tensor is exact",
           float(compress.dequantize_int8(
               *compress.quantize_int8(torch.zeros(16))).abs().max()) == 0.0)

    # -- error feedback: cumulative transmitted -> cumulative truth -------
    # simulate one device's EF loop with a COARSE quantizer (2 bits of
    # precision) so the single-step error is large: after N steps the
    # cumulative transmitted signal must still track the cumulative
    # gradient to one quantization step, not N of them.
    def c(v):      # coarse symmetric quantizer
        sc = max(1e-12, np.abs(v).max() / 3.0)
        return np.clip(np.round(v / sc), -3, 3) * sc

    g_total = np.zeros(64)
    sent_total = np.zeros(64)
    r = np.zeros(64)
    for i in range(50):
        g = np.sin(np.arange(64) * 0.1 + i)    # deterministic "gradients"
        p = g + r
        out = c(p)
        r = p - out
        g_total += g
        sent_total += out
    one_step = max(np.abs(c(g_total / 50)).max(), 1.0)
    _check(f, verbose, "error feedback keeps cumulative bias bounded",
           float(np.abs(sent_total - g_total).max()) <= one_step,
           f"drift {np.abs(sent_total - g_total).max():.3g}")

    # -- planner decompositions -------------------------------------------
    P = reshard.plan_transfer
    S = reshard.ShardSpec
    cases = [
        ("keep", P([48, 8], "float32", S(0, 4), S(0, 4)), []),
        ("slice", P([48, 8], "float32", S(None), S(0, 4)),
         ["dynamic_slice"]),
        ("gather", P([48, 8], "float32", S(0, 4), S(None)), ["all_gather"]),
        ("slice", P([48, 8], "float32", S(0, 4), S(0, 8)),
         ["dynamic_slice"]),      # nested split: no comm
        ("gather", P([48, 8], "float32", S(0, 8), S(0, 4)), ["all_gather"]),
        ("alltoall", P([48, 8], "float32", S(0, 4), S(1, 4)),
         ["all_to_all"]),
        ("redistribute", P([48, 8], "float32", S(0, 8), S(0, 6)),
         ["all_gather", "dynamic_slice"]),
    ]
    for want_kind, plan, want_steps in cases:
        _check(f, verbose, f"plan {want_kind} -> {want_steps}",
               plan.kind == want_kind and plan.collectives == want_steps,
               f"got {plan.kind} {plan.collectives}")
    _check(f, verbose, "slice moves zero wire bytes",
           P([48, 8], "float32", S(None), S(0, 4)).wire_bytes == 0)
    rd = P([48, 8], "float32", S(0, 8), S(0, 6))
    _check(f, verbose, "redistribute is priced (gather leg only)",
           rd.wire_bytes == cost.wire_bytes("all_gather", 48 * 8 * 4, 8))

    # -- wire-byte formulas -----------------------------------------------
    nb = 1 << 20
    _check(f, verbose, "ring allreduce = 2(n-1)/n",
           cost.wire_bytes("allreduce", nb, 8) == int(2 * 7 / 8 * nb))
    _check(f, verbose, "world 1 moves nothing",
           cost.wire_bytes("allreduce", nb, 1) == 0)
    _check(f, verbose, "int8 on-wire ~4x under f32",
           3.9 <= cost.compression_ratio(nb, "float32", "int8", 8) <= 4.0)
    _check(f, verbose, "bf16 on-wire 2x under f32",
           cost.compression_ratio(nb, "float32", "bf16") == 2.0)

    # -- rewrite idempotence (pure IR, no execution) ----------------------
    from ..compiler import BuildStrategy, CompiledProgram, \
        DistributedStrategy
    from ..framework import Program
    p = Program()
    gb = p.global_block()
    gb.create_parameter("w", (256, 256), "float32")
    gb.create_var("w@GRAD", (256, 256), "float32")
    gb.create_var("lr", (1,), "float32", persistable=True)
    gb.append_op("matmul", inputs={"X": ["w"], "Y": ["w"]},
                 outputs={"Out": ["w@GRAD"]}, infer_shape=False)
    gb.append_op("sgd", inputs={"Param": ["w"], "Grad": ["w@GRAD"],
                                "LearningRate": ["lr"]},
                 outputs={"ParamOut": ["w"]}, infer_shape=False)
    ds = DistributedStrategy(mesh_shape={"dp": 2})
    ds.comm_compression = "int8"
    ds.comm_compress_min_bytes = 0
    cp = CompiledProgram(p, build_strategy=BuildStrategy()) \
        .with_strategy(ds)
    info = rewrite.sync_program(p, cp)
    v1 = p._version
    _check(f, verbose, "rewrite inserts one sync op per grad",
           info is not None and info["compressed"] == ["w@GRAD"] and
           sum(1 for op in gb.ops if op.attr(rewrite.SYNC_ATTR)) == 1)
    _check(f, verbose, "residual var created (ndp-leading, persistable)",
           gb.vars[compress.residual_name("w@GRAD")].shape == (2, 256, 256))
    rewrite.sync_program(p, cp)
    _check(f, verbose, "re-sync is a no-op (no version bump)",
           p._version == v1, f"{v1} -> {p._version}")
    ds.comm_compression = "off"
    cp.with_strategy(ds)   # refresh signature path
    rewrite.sync_program(p, cp)
    _check(f, verbose, "mode=off strips the rewrite",
           not any(op.attr(rewrite.SYNC_ATTR) for op in gb.ops) and
           not any(compress.is_residual(n) for n in gb.vars))

    print(f"[comm-selftest] {len(f)} failure(s) in "
          f"{len(cases) + 12} checks")
    return len(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("python -m paddle_tpu_torch.comm")
    ap.add_argument("--selftest", action="store_true",
                    help="run the hermetic self-check and exit 0/1")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.selftest:
        return 1 if run_selftest(verbose=args.verbose) else 0
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
