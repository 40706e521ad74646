"""CLI: pre-tune a serialized Program or the built-in shape suites (the
port's copy of ``python -m paddle_tpu.tuning``).

    python -m paddle_tpu_torch.tuning prog.json         # tune a Program's ops
    python -m paddle_tpu_torch.tuning --suite resnet    # ResNet-50's conv+BN chains
    python -m paddle_tpu_torch.tuning --suite flash     # attention backends and tiles
    python -m paddle_tpu_torch.tuning                   # report persisted cache
    python -m paddle_tpu_torch.tuning --selftest        # hermetic self-check

Decisions persist to the autotune cache (``--cache`` / PADDLE_TPU_TUNE_CACHE,
default ~/.cache/paddle_tpu_torch/autotune.json), where training and serving
runs pick them up under ``PADDLE_TPU_TUNE=cached`` (the default) with zero
measurement work. Candidates are measured on the card when there is one,
on the CPU otherwise.

Exit codes: 0 ok, 1 a candidate failed to build or run, 2 usage/load errors.
"""
from __future__ import annotations

import json
import sys
from typing import List, Optional


def _parse(argv):
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tuning",
        description="Empirical autotuner: measure-and-cache route/tile/"
                    "layout selection per (shape, card)")
    ap.add_argument("program", nargs="?", default=None,
                    help="path to a Program JSON file (Program.to_json) "
                         "whose tunable ops to pre-tune")
    ap.add_argument("--suite", choices=("resnet", "flash", "all"),
                    default=None,
                    help="pre-tune a built-in shape suite instead of (or in "
                         "addition to) a program")
    ap.add_argument("--mode", choices=("off", "cached", "search"),
                    default="search",
                    help="decision mode for this invocation (default: "
                         "search -- measure misses and persist winners)")
    ap.add_argument("--batch", type=int, default=128,
                    help="batch size substituted for dynamic (-1) dims when "
                         "tuning a program (default 128)")
    ap.add_argument("--cache", metavar="PATH", default=None,
                    help="decision cache path (default "
                         "$PADDLE_TPU_TUNE_CACHE or "
                         "~/.cache/paddle_tpu_torch/autotune.json)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--warmup", type=int, default=None,
                    help="warmup calls per candidate (default "
                         "measure.WARMUP)")
    ap.add_argument("--iters", type=int, default=None,
                    help="timed calls per candidate, median taken (default "
                         "measure.ITERS)")
    ap.add_argument("--selftest", action="store_true",
                    help="run the hermetic self-check (fake timings, temp "
                         "cache; no device measurement) and exit")
    return ap.parse_args(argv)


def _fmt_text(entries: List[dict], out=None) -> None:
    out = out or sys.stdout
    if not entries:
        print("no autotune decisions", file=out)
        return
    print(f"{len(entries)} autotune decision(s):", file=out)
    for e in entries:
        print(f"\n[{e['choice']}] {e['key']}", file=out)
        src = e.get("source", "cache")
        measured = e.get("measured")
        tag = src if measured is not False else f"{src}, unmeasured"
        print(f"  winner: {e['winner']}  ({tag})", file=out)
        for cand, t in sorted((e.get("timings") or {}).items()):
            if "run_ms" in t:
                mark = " <-- winner" if cand == e["winner"] else ""
                print(f"    {cand:>12}: {t['run_ms']:9.3f} ms/run  "
                      f"(compile {t['compile_ms']:.1f} ms){mark}", file=out)
            else:
                print(f"    {cand:>12}: skipped "
                      f"({t.get('skipped', '?')})", file=out)


def _cache_report() -> List[dict]:
    from . import cache
    out = []
    for key, rec in sorted(cache.CACHE.items().items()):
        out.append({"choice": rec.get("choice", key.split("|", 1)[0]),
                    "key": key, "winner": rec.get("winner"),
                    "source": "cache", "timings": rec.get("timings", {}),
                    "measured": rec.get("measured"),
                    "search_seconds": rec.get("search_seconds")})
    return out


def _selftest() -> int:
    """Hermetic: fake timings, temp cache file; proves the decide ->
    measure -> persist -> reload pipeline without timing anything."""
    import os
    import tempfile

    import paddle_tpu_torch.tuning as tuning
    from . import cache as cache_mod
    from . import choices as choices_mod
    from . import measure as measure_mod

    # deterministic fake timings: the unfused chain wins the conv+BN shapes,
    # the kernel wins attention from S=1024 up
    def fake_time(fn, args, warmup=None, iters=None):
        name = getattr(fn, "__name__", "")
        ms = 2.0 if "kernel" in name else 3.0
        shape = tuple(getattr(args[0], "shape", ()))
        if len(shape) == 2 and "kernel" in name:
            ms = 5.0   # the conv+BN kernel loses
        if len(shape) == 4 and shape[2] >= 1024 and "kernel" not in name:
            ms = 9.0   # long-S composed attention loses
        return {"compile_ms": 1.0, "run_ms": ms, "runs_ms": [ms]}

    real_time = measure_mod.time_callable
    real_cache = cache_mod.CACHE
    # the CPU's candidate sets, on a host with a card too: the card's backend
    # choices offer the kernels alone
    real_on_card = choices_mod.on_card
    # scaled-down stand-ins for the real suites (small bench inputs): the
    # selftest checks the decide -> measure -> persist pipeline, not this
    # host's actual crossovers
    real_convbn = tuning.RESNET_CONV_BN_SHAPES
    real_flash = tuning.FLASH_SUITE_S
    tmp = tempfile.mkdtemp(prefix="paddle_tpu_torch_tune_selftest_")
    path = os.path.join(tmp, "autotune.json")
    failures = []
    try:
        measure_mod.time_callable = fake_time
        choices_mod.on_card = lambda: False
        cache_mod.reset_for_tests(path)
        tuning.RESNET_CONV_BN_SHAPES = ((896, 64, 128), (896, 128, 128))
        tuning.FLASH_SUITE_S = (128, 2048)
        entries = tuning.tune_suite("all", mode="search", dtype="float32")
        if not entries:
            failures.append("tune_suite returned no entries")
        for e in entries:
            if e["choice"] == "conv2d_bn_fused.backend" \
                    and e["winner"] != "unfused":
                failures.append(f"conv+BN verdict: {e}")
            if e["choice"] == "fused_attention.backend" \
                    and "\"s\":2048" in e["key"] and e["winner"] != "kernel":
                failures.append(f"flash S=2048 verdict: {e}")
        if not os.path.exists(path):
            failures.append("decision cache file was not written")
        with open(path, "rb") as f:
            blob1 = f.read()
        # reload round-trip: a fresh cache over the same file re-serializes
        # identically (decisions survive the hop losslessly)
        c2 = cache_mod.DecisionCache(path)
        c2.load()
        c2.save()
        with open(path, "rb") as f:
            blob2 = f.read()
        d1 = json.dumps(json.loads(blob1)["decisions"], sort_keys=True)
        d2 = json.dumps(json.loads(blob2)["decisions"], sort_keys=True)
        if d1 != d2:
            failures.append("decision cache round-trip drifted")

        # cached mode answers from the store without measuring
        def boom(*a, **k):
            raise AssertionError("cached mode must not measure")
        measure_mod.time_callable = boom
        cache_mod.reset_for_tests(path)
        again = tuning.tune_suite("resnet", mode="cached", dtype="float32")
        for e in again:
            if e["winner"] != "unfused":
                failures.append(f"cached-mode answer drifted: {e}")
    finally:
        measure_mod.time_callable = real_time
        choices_mod.on_card = real_on_card
        cache_mod.CACHE = real_cache
        tuning.RESNET_CONV_BN_SHAPES = real_convbn
        tuning.FLASH_SUITE_S = real_flash
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        print("selftest FAILED:", file=sys.stderr)
        for f in failures:
            print(f"  - {f}", file=sys.stderr)
        return 1
    print("selftest ok: searched, persisted, round-tripped identically, "
          "cached mode measurement-free")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = _parse(argv)
    if args.selftest:
        return _selftest()

    import os
    if args.cache:
        os.environ["PADDLE_TPU_TUNE_CACHE"] = args.cache
        from . import cache as cache_mod
        cache_mod.reset_for_tests(args.cache)

    from . import measure as measure_mod
    if args.warmup is not None:
        measure_mod.WARMUP = args.warmup
    if args.iters is not None:
        measure_mod.ITERS = args.iters

    import paddle_tpu_torch.tuning as tuning
    entries: List[dict] = []
    try:
        if args.program:
            try:
                with open(args.program) as f:
                    data = f.read()
            except OSError as e:
                print(f"error: cannot read {args.program!r}: {e}",
                      file=sys.stderr)
                return 2
            from ..framework import Program
            try:
                prog = Program.from_json(data)
            except Exception as e:
                print(f"error: {args.program!r} is not a serialized "
                      f"Program: {e}", file=sys.stderr)
                return 2
            entries += tuning.tune_program(prog, batch=args.batch,
                                           mode=args.mode)
        if args.suite:
            entries += tuning.tune_suite(args.suite, mode=args.mode)
        if not args.program and not args.suite:
            from . import cache as cache_mod
            cache_mod.CACHE.load()
            entries = _cache_report()
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except measure_mod.CandidateFailed as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    if args.format == "json":
        print(json.dumps({
            "device_kind": tuning.device_kind(),
            "mode": args.mode,
            "cache": tuning.cache.CACHE.path,
            "decisions": entries,
        }, indent=1, sort_keys=True, default=str))
    else:
        _fmt_text(entries)
        print(f"\ncache: {tuning.cache.CACHE.path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
