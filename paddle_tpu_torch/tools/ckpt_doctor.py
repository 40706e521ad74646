"""Checkpoint chaos doctor: verify a checkpoint tree's integrity, or fuzz
it with seeded damage and assert the restore path degrades correctly (the
port's copy of the JAX package's ``tools/ckpt_doctor.py``, over the port's
``io.verify_checkpoint``, ``utils/fs`` and ``Checkpointer``; the two
packages write one checkpoint format, so either doctor reads either tree).

    python -m paddle_tpu_torch.tools.ckpt_doctor verify CKPT_DIR \
        [--level size|crc] [--format text|json]
    python -m paddle_tpu_torch.tools.ckpt_doctor fuzz CKPT_DIR [--seed N] \
        [--format json]
    python -m paddle_tpu_torch.tools.ckpt_doctor --selftest [--device cpu]

``verify`` walks every ``ckpt-*`` step under the tree (or treats the
directory as a single checkpoint when it holds a manifest directly) and
reports per-rank, per-chunk verdicts from ``io.verify_checkpoint``:
``ok`` / ``missing`` / ``size_mismatch`` / ``crc_mismatch`` /
``unverified`` (pre-v2 manifest) / ``manifest`` (unreadable).  Exit 0 =
every step verifies, 1 = problems found, 2 = usage.

``fuzz`` is DESTRUCTIVE: it applies one seeded mutation per case to the
tree (bit-flip a chunk, truncate a chunk, delete a rank manifest, point
LATEST at a missing step) and asserts the contract after each:

- damage is *detected* (never silently restorable),
- ``latest_step()`` falls through to the newest genuinely-complete step
  (after quarantine, for the crc case -- size scans cannot see a
  bit-flip),
- a stale LATEST degrades to the directory scan.

Each case consumes at most one step of the tree; cases beyond the number
of available complete steps are reported as skipped.
"""
from __future__ import annotations

import argparse
import json
import random
import sys


def _is_step_tree(dirname) -> bool:
    from ..utils import fs as fsio
    try:
        names = fsio.listdir(dirname)
    except OSError:
        return False
    return any(n.startswith("ckpt-") for n in names)


def _step_dirs(dirname):
    """(step, name) of every ckpt-<int> dir, newest first; quarantined
    ``.corrupt`` trees are listed separately."""
    from ..utils import fs as fsio
    steps, quarantined = [], []
    for n in fsio.listdir(dirname):
        if not n.startswith("ckpt-"):
            continue
        tail = n.split("-", 1)[1]
        if tail.isdigit():
            steps.append((int(tail), n))
        elif ".corrupt" in tail:
            quarantined.append(n)
    return sorted(steps, reverse=True), sorted(quarantined)


def verify_tree(dirname, level: str = "crc") -> dict:
    """Verdicts for every step in the tree (or the single checkpoint)."""
    from .. import io as pio
    from ..utils import fs as fsio
    out = {"dir": str(dirname), "level": level, "ok": True, "steps": [],
           "quarantined": [], "latest_complete_step": -1}
    if _is_step_tree(dirname):
        steps, out["quarantined"] = _step_dirs(dirname)
        targets = [(s, fsio.join(dirname, n)) for s, n in steps]
    else:
        targets = [(None, dirname)]
    for step, d in targets:
        rep = pio.verify_checkpoint(d, level=level)
        bad = [c for c in rep["chunks"] if c["status"] not in
               ("ok", "unverified")]
        n_unv = sum(1 for c in rep["chunks"] if c["status"] == "unverified")
        out["steps"].append({
            "step": step, "dir": str(d), "ok": rep["ok"],
            "format_version": rep["format_version"],
            "nranks": rep["nranks"], "n_chunks": len(rep["chunks"]),
            "n_unverified": n_unv, "problems": bad})
        if not rep["ok"]:
            out["ok"] = False
        elif step is not None and out["latest_complete_step"] < 0:
            out["latest_complete_step"] = step
    return out


def _fmt_verify_text(rep, out=sys.stdout):
    print(f"ckpt_doctor verify {rep['dir']} (level={rep['level']})",
          file=out)
    for s in rep["steps"]:
        name = f"ckpt-{s['step']}" if s["step"] is not None else s["dir"]
        if s["ok"]:
            extra = (f", {s['n_unverified']} unverified(pre-v2)"
                     if s["n_unverified"] else "")
            print(f"  {name}: OK ({s['nranks']} rank(s), "
                  f"{s['n_chunks']} chunk(s), format "
                  f"v{s['format_version']}{extra})", file=out)
            continue
        print(f"  {name}: CORRUPT", file=out)
        for c in s["problems"][:20]:
            where = f"rank {c['rank']} " if c.get("rank") is not None else ""
            print(f"    {where}{c.get('file') or c.get('var') or '?'}: "
                  f"{c['status']} ({c.get('detail')})", file=out)
        if len(s["problems"]) > 20:
            print(f"    ... {len(s['problems']) - 20} more", file=out)
    for q in rep["quarantined"]:
        print(f"  {q}: quarantined (ignored by the resume scan)", file=out)
    if rep["latest_complete_step"] >= 0:
        print(f"  newest restorable step: {rep['latest_complete_step']}",
              file=out)


# -- fuzz --------------------------------------------------------------------

FUZZ_CASES = ("bitflip", "truncate", "manifest", "latest")


def _chunk_files(d):
    from ..utils import fs as fsio
    return sorted(n for n in fsio.listdir(d) if n.endswith(".npy"))


def fuzz_tree(dirname, seed: int = 0, cases=FUZZ_CASES) -> dict:
    """Apply one seeded mutation per case (DESTRUCTIVE) and assert the
    restore path degrades correctly after each.  Returns the per-case
    verdicts; ``ok`` is the all-cases conjunction."""
    from .. import io as pio
    from ..utils import fs as fsio
    from ..utils.checkpointer import Checkpointer
    rng = random.Random(seed)
    ck = Checkpointer(None, None, dirname)
    out = {"dir": str(dirname), "seed": seed, "ok": True, "cases": []}

    def case(name, **kw):
        rec = dict(case=name, **kw)
        out["cases"].append(rec)
        if not rec.get("ok"):
            out["ok"] = False
        return rec

    # stale LATEST first: non-destructive to the steps themselves
    if "latest" in cases:
        before = ck.latest_step()
        with fsio.open_file(fsio.join(dirname, "LATEST"), "w") as f:
            json.dump({"step": 999999999, "time": 0}, f)
        after = ck.latest_step()
        case("latest", detail="LATEST -> missing step 999999999",
             expect="scan falls back to newest complete step",
             before=before, after=after, ok=(after == before))

    for name in cases:
        if name == "latest":
            continue
        steps = list(ck._complete_steps())
        if not steps:
            case(name, ok=None, skipped=True,
                 detail="no complete step left to damage")
            continue
        victim_step = steps[0]
        fall_to = steps[1] if len(steps) > 1 else -1
        d = ck._step_dir(victim_step)
        if name == "bitflip":
            files = _chunk_files(d)
            f = files[rng.randrange(len(files))]
            path = fsio.join(d, f)
            data = bytearray(fsio.read_bytes(path))
            pos = rng.randrange(len(data))
            data[pos] ^= 1 << rng.randrange(8)
            fsio.write_bytes(path, bytes(data))
            # same size: the cheap scan must still call it complete, the
            # crc verify must catch it, and quarantine must fall through
            still_complete = ck._is_complete(d)
            detected = not pio.verify_checkpoint(d, level="crc")["ok"]
            ck.quarantine(victim_step, reason="doctor fuzz bitflip")
            after = ck.latest_step()
            case("bitflip", file=f, byte=pos, step=victim_step,
                 expect="size-scan complete, crc detects, quarantine "
                        "falls through",
                 size_scan_complete=still_complete, crc_detected=detected,
                 after=after,
                 ok=(still_complete and detected and after == fall_to))
        elif name == "truncate":
            files = _chunk_files(d)
            f = files[rng.randrange(len(files))]
            path = fsio.join(d, f)
            data = fsio.read_bytes(path)
            fsio.write_bytes(path, data[:max(1, len(data) // 2)])
            after = ck.latest_step()
            case("truncate", file=f, step=victim_step,
                 expect="size scan rejects the step",
                 complete=ck._is_complete(d), after=after,
                 ok=(not ck._is_complete(d) and after == fall_to))
        elif name == "manifest":
            import os as _os
            man = [n for n in fsio.listdir(d)
                   if n.startswith("__manifest__")]
            path = fsio.join(d, sorted(man)[-1])
            _os.remove(path) if not fsio.is_remote(path) else \
                fsio.rmtree(path)
            after = ck.latest_step()
            case("manifest", file=sorted(man)[-1], step=victim_step,
                 expect="manifest-less step rejected",
                 complete=ck._is_complete(d), after=after,
                 ok=(not ck._is_complete(d) and after == fall_to))
    return out


def _fmt_fuzz_text(rep, out=sys.stdout):
    print(f"ckpt_doctor fuzz {rep['dir']} (seed={rep['seed']})", file=out)
    for c in rep["cases"]:
        if c.get("skipped"):
            print(f"  {c['case']}: SKIPPED ({c['detail']})", file=out)
            continue
        verdict = "PASS" if c["ok"] else "FAIL"
        tgt = f" [{c.get('file')}]" if c.get("file") else ""
        print(f"  {c['case']}{tgt}: {verdict} -- {c['expect']}", file=out)
    print(f"  overall: {'PASS' if rep['ok'] else 'FAIL'}", file=out)


# -- selftest ----------------------------------------------------------------

def selftest(device=None) -> int:
    """Hermetic fuzz round-trip on a temp tree: build a real 4-step
    checkpoint sequence from a tiny training run on ``device`` (None: the
    card), fuzz every case, and drive the full restore path (bit-flip ->
    restore() -> quarantine + fall-through, restored state == the previous
    step's bytes)."""
    import os
    import tempfile

    import numpy as np

    import paddle_tpu_torch as fluid
    from .. import io as pio
    from ..core.executor import to_numpy
    from ..resilience.__main__ import _build_workload
    from ..utils import fs as fsio
    from ..utils.checkpointer import Checkpointer

    main, startup, loss = _build_workload(dim=4, seed=11)
    rs = np.random.RandomState(11)

    with tempfile.TemporaryDirectory() as td:
        tree = os.path.join(td, "ck")
        scope = fluid.Scope()
        states = {}
        with fluid.scope_guard(scope):
            exe = fluid.Executor(device)
            exe.run(startup)
            ck = Checkpointer(exe, main, tree, max_to_keep=4)
            for step in range(4):
                exe.run(main, feed={"x": rs.rand(2, 4).astype("float32")},
                        fetch_list=[loss])
                ck.save(step)
                states[step] = {
                    n: to_numpy(scope.find_var(n)).copy()
                    for n, v in main.global_block().vars.items()
                    if v.persistable and scope.find_var(n) is not None}
            exe.close()

        rep = verify_tree(tree, level="crc")
        assert rep["ok"] and rep["latest_complete_step"] == 3, rep

        # full restore path on a bit-flipped newest step: detection,
        # quarantine, fall-through, and the fallen-to state is exact
        d = os.path.join(tree, "ckpt-3")
        f = _chunk_files(d)[0]
        data = bytearray(fsio.read_bytes(os.path.join(d, f)))
        data[len(data) // 2] ^= 0x10
        fsio.write_bytes(os.path.join(d, f), bytes(data))
        scope2 = fluid.Scope()
        with fluid.scope_guard(scope2):
            exe2 = fluid.Executor(device)
            exe2.run(startup)
            ck2 = Checkpointer(exe2, main, tree)
            got = ck2.restore()
            assert got == 2, f"restore fell to {got}, expected 2"
            for n, want in states[2].items():
                have = to_numpy(scope2.find_var(n))
                assert have.tobytes() == want.tobytes(), \
                    f"{n} differs after fall-through restore"
            exe2.close()
        q = [n for n in os.listdir(tree) if n.endswith(".corrupt")]
        assert q == ["ckpt-3.corrupt"], q

        # fuzz the remaining (complete) steps through every case
        rep = fuzz_tree(tree, seed=7)
        ran = [c for c in rep["cases"] if not c.get("skipped")]
        assert rep["ok"], json.dumps(rep, indent=2)
        assert len(ran) >= 3, rep   # latest + >= 2 destructive cases

        # verify now flags what fuzz broke
        assert not verify_tree(tree, level="crc")["ok"]

        # old-format (v1) tree still verifies as unverified-but-ok
        v1 = os.path.join(td, "v1")
        scope3 = fluid.Scope()
        with fluid.scope_guard(scope3):
            exe3 = fluid.Executor(device)
            exe3.run(startup)
            pio.save_persistables(exe3, v1, main)
            man = json.load(open(os.path.join(v1, "__manifest__.json")))
            man.pop("format_version")
            for m in man["vars"]:
                for ch in m["chunks"]:
                    ch.pop("bytes"), ch.pop("crc32")
            json.dump(man, open(os.path.join(v1, "__manifest__.json"), "w"))
            rep = verify_tree(v1, level="crc")
            assert rep["ok"], rep
            assert rep["steps"][0]["n_unverified"] > 0, rep
            exe3.close()
    print("ckpt doctor selftest: OK")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.ckpt_doctor",
        description="verify a checkpoint tree's integrity, or fuzz it "
                    "(DESTRUCTIVE) and assert the restore path degrades "
                    "correctly")
    ap.add_argument("command", nargs="?", choices=("verify", "fuzz"))
    ap.add_argument("dir", nargs="?", help="checkpoint tree (a Checkpointer "
                    "dirname holding ckpt-* steps, or one step dir)")
    ap.add_argument("--level", choices=("size", "crc"), default="crc",
                    help="verify depth: size = stat-only completeness "
                         "scan, crc = full checksum read (default)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cases", default=",".join(FUZZ_CASES),
                    help=f"fuzz cases, comma-separated "
                         f"(default {','.join(FUZZ_CASES)})")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--device", default=None,
                    help="selftest: the training run's device (default: the card; "
                         "'cpu')")
    ap.add_argument("--selftest", action="store_true")
    args = ap.parse_args(argv)
    if args.selftest:
        return selftest(args.device)
    if not args.command or not args.dir:
        ap.print_usage(sys.stderr)
        print("ckpt_doctor: need a command (verify|fuzz) and a checkpoint "
              "dir", file=sys.stderr)
        return 2
    try:
        if args.command == "verify":
            rep = verify_tree(args.dir, level=args.level)
            fmt = _fmt_verify_text
        else:
            cases = [c.strip() for c in args.cases.split(",") if c.strip()]
            unknown = [c for c in cases if c not in FUZZ_CASES]
            if unknown:
                print(f"ckpt_doctor: unknown fuzz case(s) {unknown}; use "
                      f"{FUZZ_CASES}", file=sys.stderr)
                return 2
            rep = fuzz_tree(args.dir, seed=args.seed, cases=tuple(cases))
            fmt = _fmt_fuzz_text
    except Exception as e:  # noqa: BLE001 -- CLI boundary
        print(f"ckpt_doctor failed: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    if args.format == "json":
        print(json.dumps(rep, indent=2, sort_keys=True, default=str))
    else:
        fmt(rep)
    return 0 if rep["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
