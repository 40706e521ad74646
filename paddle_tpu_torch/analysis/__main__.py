"""CLI: lint a serialized Program (``Program.to_json`` output of either
package); the port's copy of ``python -m paddle_tpu.analysis``.

    python -m paddle_tpu_torch.analysis prog.json [--fetch loss] [--feed img]
    python -m paddle_tpu_torch.analysis prog.json --mem-budget 8G \
        --batch 256                          # memory planner (PT05x)
    python -m paddle_tpu_torch.analysis prog.json --baseline accepted.keys \
        [--update-baseline]                  # CI: gate on NEW findings only
    python -m paddle_tpu_torch.analysis --codes      # diagnostic-code table
    python -m paddle_tpu_torch.analysis --selftest   # pinned by the tests

The flags are the JAX CLI's. ``--strategy`` and ``--auto-shard`` exit 2
naming ROADMAP item 13 (c) (the distributed checks and the auto-sharding
planner are not ported). Exit status: 0 clean (below the --fail-on bar), 1
findings at/above the bar, 2 usage/load errors.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from ..framework import Program
from . import (CODES, ITEM_13, Severity, apply_baseline, codes_table,
               count_by_severity, format_diagnostics, load_baseline,
               registered_passes, verify, write_baseline)


def parse_bytes(s: str) -> int:
    """argparse type wrapper over memplan.parse_bytes."""
    from .memplan import parse_bytes as _pb
    try:
        return _pb(s)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"not a byte count: {s!r} (use an int or a K/M/G/T suffix)")


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.analysis",
        description="Static verifier/linter for paddle_tpu_torch Programs")
    ap.add_argument("program", nargs="?",
                    help="path to a Program JSON file (Program.to_json), "
                         "or '-' for stdin")
    ap.add_argument("--format", choices=("text", "json"), default="text",
                    help="output format (default text)")
    ap.add_argument("--fetch", action="append", default=None,
                    metavar="NAME", help="fetch target (repeatable); "
                    "enables dead-op/reachability analysis")
    ap.add_argument("--feed", action="append", default=None, metavar="NAME",
                    help="feed var name (repeatable)")
    ap.add_argument("--passes", default=None,
                    help="comma-separated pass subset "
                         f"(default: all of {registered_passes()})")
    ap.add_argument("--strategy", default=None, metavar="FILE",
                    help="DistributedStrategy JSON: the PT04x distributed "
                         "checks are ROADMAP item 13 (c)'s and not ported "
                         "(exits 2)")
    ap.add_argument("--mem-budget", default=None, type=parse_bytes,
                    metavar="BYTES",
                    help="per-device memory budget (int or K/M/G/T suffix); "
                         "runs the static peak-memory planner (PT05x) and "
                         "errors when the estimate exceeds it")
    ap.add_argument("--batch", default=None, type=int,
                    help="batch size resolving dynamic (-1) dims for the "
                         "memory planner and divisibility checks")
    ap.add_argument("--auto-shard", action="store_true",
                    help="the static auto-sharding planner (PT07x) is "
                         "ROADMAP item 13 (c)'s and not ported (exits 2)")
    ap.add_argument("--top-k", default=None, type=int, metavar="K",
                    help="ranked plans the auto-shard search keeps "
                         "(with --auto-shard only)")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="suppression file of accepted Diagnostic keys: "
                         "findings matching an entry are dropped before "
                         "output/exit-code, so CI gates on NEW findings "
                         "only (write one with --update-baseline)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="write the current findings' keys to --baseline "
                         "(byte-stable ordering) and exit 0")
    ap.add_argument("--fail-on", choices=("error", "warn", "never"),
                    default="error",
                    help="exit 1 when findings at/above this severity "
                         "exist (default error)")
    ap.add_argument("--no-stack", action="store_true",
                    help="omit op creation stacks from text output")
    ap.add_argument("--codes", action="store_true",
                    help="print the diagnostic-code table and exit")
    ap.add_argument("--selftest", action="store_true",
                    help="run the built-in end-to-end check and exit")
    return ap


def _load_program(path: str) -> Program:
    data = sys.stdin.read() if path == "-" else open(path).read()
    return Program.from_json(data)


def _emit(diags, args) -> None:
    if args.format == "json":
        print(json.dumps({
            "findings": [d.to_dict() for d in diags],
            "counts": count_by_severity(diags),
        }, indent=2, sort_keys=True))
    else:
        print(format_diagnostics(diags, with_stack=not args.no_stack))


def _exit_code(diags, fail_on: str) -> int:
    if fail_on == "never":
        return 0
    bad = {Severity.ERROR} if fail_on == "error" else \
        {Severity.ERROR, Severity.WARN}
    return 1 if any(d.severity in bad for d in diags) else 0


# ---------------------------------------------------------------- selftest --

def _selftest() -> int:
    """Build minimal trigger programs in-process and pin the expected codes
    (the CI analog of obs_report --selftest)."""
    failures: List[str] = []

    def expect(tag: str, diags, *, has=(), lacks=(), no_errors=False):
        codes = {d.code for d in diags}
        for c in has:
            if c not in codes:
                failures.append(f"{tag}: expected {c}, got {sorted(codes)}")
        for c in lacks:
            if c in codes:
                failures.append(f"{tag}: unexpected {c}")
        if no_errors and any(d.severity == Severity.ERROR for d in diags):
            failures.append(
                f"{tag}: unexpected errors: "
                + "; ".join(d.format() for d in diags
                            if d.severity == Severity.ERROR))

    # clean single-op program: x(data) -> relu -> y, fetched
    p = Program()
    b = p.global_block()
    b.create_var("x", (-1, 4), "float32", is_data=True)
    b.append_op("relu", inputs={"X": ["x"]}, outputs={"Out": ["y"]})
    expect("clean", verify(p, fetch_names=["y"]), no_errors=True,
           lacks=("PT001", "PT004", "PT012"))

    # undefined input var + unregistered op type
    p = Program()
    b = p.global_block()
    b.append_op("relu", inputs={"X": ["ghost"]}, outputs={"Out": ["y"]},
                infer_shape=False)
    b.append_op("definitely_not_an_op", inputs={}, outputs={"Out": ["z"]},
                infer_shape=False)
    expect("undefined/unregistered", verify(p), has=("PT001", "PT004"))

    # write-after-write, no read between
    p = Program()
    b = p.global_block()
    b.append_op("fill_constant", outputs={"Out": ["c"]},
                attrs={"shape": [2], "dtype": "float32", "value": 1.0})
    b.append_op("fill_constant", outputs={"Out": ["c"]},
                attrs={"shape": [2], "dtype": "float32", "value": 2.0})
    expect("waw", verify(p, fetch_names=["c"]), has=("PT013",))

    # declared dtype disagrees with inference
    p = Program()
    b = p.global_block()
    b.create_var("x", (4,), "float32", is_data=True)
    b.create_var("y", (4,), "int32")
    b.append_op("relu", inputs={"X": ["x"]}, outputs={"Out": ["y"]},
                infer_shape=False)
    expect("dtype clash", verify(p), has=("PT020",))

    # dynamic non-batch dim on a feed
    p = Program()
    b = p.global_block()
    b.create_var("seq", (-1, -1, 8), "float32", is_data=True)
    b.append_op("relu", inputs={"X": ["seq"]}, outputs={"Out": ["y"]},
                infer_shape=False)
    expect("recompile risk", verify(p), has=("PT030",))

    # serialization round trip reports identical findings
    p = Program()
    b = p.global_block()
    b.create_var("x", (-1, 4), "float32", is_data=True)
    b.append_op("relu", inputs={"X": ["x"]}, outputs={"Out": ["y"]})
    b.append_op("definitely_not_an_op", inputs={"X": ["y"]},
                outputs={"Out": ["z"]}, infer_shape=False)
    d1 = verify(p, fetch_names=["z"])
    d2 = verify(Program.from_json(p.to_json()), fetch_names=["z"])
    if [d.key() for d in d1] != [d.key() for d in d2]:
        failures.append("round-trip: diagnostics differ:\n"
                        f"{[d.key() for d in d1]}\nvs\n"
                        f"{[d.key() for d in d2]}")

    # a collective is never dead, even with no strategy to check it against
    p = Program()
    b = p.global_block()
    b.create_var("x", (8, 4), "float32", is_data=True)
    b.append_op("c_allreduce_sum", inputs={"X": ["x"]},
                outputs={"Out": ["red"]}, attrs={"axis_name": "mp"},
                infer_shape=False)
    b.append_op("relu", inputs={"X": ["x"]}, outputs={"Out": ["y"]})
    expect("collective liveness", verify(p, fetch_names=["y"]),
           lacks=("PT010",))

    # memory planner: tiny budget trips PT051, assumed batch trips PT052
    p = Program()
    b = p.global_block()
    b.create_var("x", (-1, 1024), "float32", is_data=True)
    b.append_op("relu", inputs={"X": ["x"]}, outputs={"Out": ["y"]})
    diags = verify(p, fetch_names=["y"], mem_budget=16)
    expect("mem budget", diags, has=("PT050", "PT051", "PT052"))
    expect("mem budget ok", verify(p, fetch_names=["y"], batch=4,
                                   mem_budget=1 << 30),
           has=("PT050",), lacks=("PT051", "PT052"))

    # baseline round trip: accepted findings suppress byte-stably
    import tempfile
    p = Program()
    b = p.global_block()
    b.append_op("relu", inputs={"X": ["ghost"]}, outputs={"Out": ["y"]},
                infer_shape=False)
    diags = verify(p)
    with tempfile.NamedTemporaryFile("w", suffix=".keys",
                                     delete=False) as f:
        base_path = f.name
    try:
        write_baseline(base_path, diags)
        kept, supp = apply_baseline(verify(p), load_baseline(base_path))
        if kept or len(supp) != len(diags):
            failures.append(f"baseline: kept {len(kept)}, suppressed "
                            f"{len(supp)} of {len(diags)}")
    finally:
        import os
        os.unlink(base_path)

    if failures:
        print("selftest: FAILED")
        for f in failures:
            print("  -", f)
        return 1
    print(f"selftest: OK ({len(CODES)} codes registered, "
          f"passes: {', '.join(registered_passes())})")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)
    if args.codes:
        print(codes_table())
        return 0
    if args.selftest:
        return _selftest()
    if not args.program:
        build_arg_parser().print_usage()
        print("error: need a program JSON path (or --codes/--selftest)")
        return 2
    if args.update_baseline and not args.baseline:
        print("error: --update-baseline needs --baseline FILE")
        return 2
    try:
        program = _load_program(args.program)
    except (OSError, ValueError, KeyError) as e:
        print(f"error: cannot load program from {args.program!r}: {e}")
        return 2
    if args.strategy or args.auto_shard:
        flag = "--auto-shard" if args.auto_shard else "--strategy"
        print(f"error: {flag}: {ITEM_13}")
        return 2
    passes = args.passes.split(",") if args.passes else None
    try:
        diags = verify(program, feed_names=args.feed,
                       fetch_names=args.fetch, passes=passes,
                       mem_budget=args.mem_budget, batch=args.batch)
    except (KeyError, ValueError) as e:
        print(f"error: {e}")
        return 2
    if args.update_baseline:
        n = write_baseline(args.baseline, diags)
        print(f"baseline: wrote {n} entr(ies) to {args.baseline}")
        return 0
    if args.baseline:
        try:
            keys = load_baseline(args.baseline)
        except (OSError, ValueError) as e:
            print(f"error: cannot load baseline from {args.baseline!r}: {e}")
            return 2
        diags, suppressed = apply_baseline(diags, keys)
        if suppressed and args.format == "text":
            print(f"(baseline: {len(suppressed)} finding(s) suppressed by "
                  f"{args.baseline})")
    _emit(diags, args)
    return _exit_code(diags, args.fail_on)


if __name__ == "__main__":
    sys.exit(main())
