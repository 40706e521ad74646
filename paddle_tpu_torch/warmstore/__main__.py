"""The warm store's CLI.

    python -m paddle_tpu_torch.warmstore [--root DIR] ls
    python -m paddle_tpu_torch.warmstore [--root DIR] verify      # rc 1 on damage
    python -m paddle_tpu_torch.warmstore [--root DIR] gc --max-bytes N
    python -m paddle_tpu_torch.warmstore [--root DIR] prefetch
    python -m paddle_tpu_torch.warmstore --selftest               # hermetic

``--root`` defaults to ``PADDLE_TPU_WARMSTORE``. ``verify`` exits 1 when an
entry fails its checksum or is quarantined. ``prefetch`` makes the stored
steps' kernels ready on this card (restored, or compiled by ``nvcc``).
``--selftest`` works in a temporary store, on the CPU: a kernel library's
round trip through tier A under a forced passing verdict (byte-identical),
a forced failing verdict that never reads tier A, the quarantine of a
corrupt step record, and ``gc``; no card, no network, nothing kept.
"""
from __future__ import annotations

import argparse
import os
import sys


def _store(root):
    if not root:
        print("error: no store root (pass --root or set PADDLE_TPU_WARMSTORE)",
              file=sys.stderr)
        return None
    from .store import WarmStore
    return WarmStore(root)


def _cmd_ls(store) -> int:
    rows = store.ls()
    for r in rows:
        mark = "CORRUPT " if r["corrupt"] else ""
        print(f"{r['digest']}  {mark}kind={r['kind'] or '-'} "
              f"tiers={''.join(r['tiers']) or '-'} bytes={r['bytes']}")
    print(f"{len(rows)} entries, {sum(r['bytes'] for r in rows)} bytes")
    return 0


def _cmd_verify(store) -> int:
    problems = store.verify()
    for p in problems:
        print(f"BAD {p}")
    print(f"verify: {len(problems)} problem(s)")
    return 1 if problems else 0


def _cmd_gc(store, max_bytes: int) -> int:
    removed = store.gc(max_bytes)
    for name in removed:
        print(f"evicted {name}")
    print(f"gc: removed {len(removed)} entries")
    return 0


def _cmd_prefetch(store) -> int:
    print(f"prefetch: {store.prefetch()} entries readable")
    return 0


def selftest() -> int:
    """Both forced verdicts, quarantine and gc, in a temporary store."""
    import glob
    import tempfile
    import warnings
    failures = []

    def check(name, cond):
        print(f"{'ok' if cond else 'FAIL'}: {name}")
        if not cond:
            failures.append(name)

    saved = os.environ.get("PADDLE_TPU_WARMSTORE_PROBE")
    with tempfile.TemporaryDirectory(prefix="paddle_tpu_torch_ws_self_") as td:
        from . import keys as _keys
        from . import probe as _probe
        from .store import WarmStore
        os.environ["PADDLE_TPU_WARMSTORE_PROBE"] = "pass"
        _probe.reset_for_tests()
        store = WarmStore(os.path.join(td, "store"))

        # tier A: a library file (its bytes stand for nvcc's output) round trip
        libname = "libselftest-0123456789ab.so"
        src = os.path.join(td, libname)
        blob = os.urandom(4096)
        with open(src, "wb") as f:
            f.write(blob)
        store.offer_library(libname, src)
        key = {"format": 1, "kind": "selftest", "n": 1}
        store.offer(key, {"kernels": [{"name": "selftest", "library": libname,
                                       "digest": "0123456789ab"}], "capture": {}})
        check("offers flushed", store.flush(30.0))
        dest = os.path.join(td, "restored.so")
        check("forced pass restores the library", store.restore_library(libname, dest))
        check("tier-A round trip byte-identical",
              os.path.isfile(dest) and open(dest, "rb").read() == blob)
        hit = store.consult(key)
        check("the step's record hits tier B", hit is not None and hit.tier == "b"
              and hit.kernels == ["selftest"])

        # a failing verdict: tier A is never read, the warning fires once
        os.environ["PADDLE_TPU_WARMSTORE_PROBE"] = "fail"
        _probe.reset_for_tests()
        reads = []
        real = store._load_tier_a
        store._load_tier_a = lambda path: (reads.append(path), real(path))[1]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            restored = store.restore_library(libname, os.path.join(td, "again.so"))
            store.restore_library(libname, os.path.join(td, "again.so"))
        store._load_tier_a = real
        check("forced fail restores nothing", not restored)
        check("tier A never read (spy counts 0)", reads == [])
        check("the self-disable warns exactly once",
              sum("tier A" in str(w.message) for w in caught) == 1)
        check("the record still hits tier B", store.consult(key) is not None)
        check("no probe subprocess spawned", _probe.SPAWNS == 0)

        # a corrupt record: quarantined, missed, reported
        entry = os.path.join(td, "store", "entries", _keys.digest(key))
        victim = os.path.join(entry, "tier_b.json")
        data = bytearray(open(victim, "rb").read())
        data[len(data) // 2] ^= 0x01
        open(victim, "wb").write(bytes(data))
        check("a corrupt entry misses", store.consult(key) is None)
        check("a corrupt entry is quarantined",
              glob.glob(os.path.join(td, "store", "entries", "*.corrupt")) != [])
        check("verify reports the quarantine",
              any("quarantined" in p for p in store.verify()))
        store.gc(0)
        check("gc empties the store", store.ls() == [])
        store.close()
    if saved is None:
        os.environ.pop("PADDLE_TPU_WARMSTORE_PROBE", None)
    else:
        os.environ["PADDLE_TPU_WARMSTORE_PROBE"] = saved
    from . import probe as _probe
    _probe.reset_for_tests()
    print(f"warmstore selftest: {'PASS' if not failures else 'FAIL'} "
          f"({len(failures)} failure(s))")
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m paddle_tpu_torch.warmstore")
    ap.add_argument("--root", default=os.environ.get("PADDLE_TPU_WARMSTORE"))
    ap.add_argument("--selftest", action="store_true")
    sub = ap.add_subparsers(dest="cmd")
    sub.add_parser("ls")
    sub.add_parser("verify")
    gp = sub.add_parser("gc")
    gp.add_argument("--max-bytes", type=int, required=True)
    sub.add_parser("prefetch")
    args = ap.parse_args(argv)
    if args.selftest:
        return selftest()
    store = _store(args.root)
    if store is None:
        return 2
    if args.cmd == "ls":
        return _cmd_ls(store)
    if args.cmd == "verify":
        return _cmd_verify(store)
    if args.cmd == "gc":
        return _cmd_gc(store, args.max_bytes)
    if args.cmd == "prefetch":
        return _cmd_prefetch(store)
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
