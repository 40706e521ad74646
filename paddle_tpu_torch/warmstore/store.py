"""The on-disk warm store: checksummed, content-addressed, written off the
step path (the port's copy of ``paddle_tpu/warmstore/store.py``).

Layout, under the ``PADDLE_TPU_WARMSTORE`` root::

    entries/<digest32>/        one step (kind train_step / fused_step / predict)
        tier_b.json   the portable record: the kernels the step launched
                      (name, library file, source digest) and the parts of
                      its capture (graph pool and argument bytes)
        meta.json     written last (the commit point): the key, each
                      file's crc32 and size
    entries/<digest32>/        one kernel library (kind library), keyed by
        tier_a.so     its file name lib<name>-<source digest>.so and the
        meta.json     build: steps that launch one kernel share its entry
    entries/<digest32>.corrupt/   quarantined entries (checksum or parse failed)
    probe/                        the probe's verdict, one per build
    tmp/                          staging for the atomic writes

Write discipline as for checkpoints: every entry is staged under ``tmp/``
and lands by one rename, meta.json inside it; readers ignore a directory
without meta.json. A read checksums every file it uses; a mismatch or a
parse failure quarantines the entry (renamed ``.corrupt``) and reports a
miss, so a bad store never fails a step. Writes run on a lazy daemon
writer thread, and only on rank 0. The ``warmstore_write`` fault site
mutates an entry after its commit, so the read side's checks are what
the chaos cases exercise.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional

from ..observability import journal as _journal
from ..observability.metrics import REGISTRY as _OBS
from ..utils import fs as _fsio
from . import keys as _keys
from . import probe as _probe

META_FORMAT = 1
TIER_A = "tier_a.so"
TIER_B = "tier_b.json"


class Hit:
    """A validated hit of a step's record. ``tier`` is "b" (the record);
    ``value`` is the record dict; the step's kernel libraries are tier A,
    restored one by one (``restore_library``)."""

    __slots__ = ("tier", "value", "meta", "digest")

    def __init__(self, tier: str, value, meta: dict, digest: str):
        self.tier = tier
        self.value = value
        self.meta = meta
        self.digest = digest

    @property
    def kernels(self) -> List[str]:
        return [k["name"] for k in self.value.get("kernels", [])]


def _crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


class WarmStore:
    def __init__(self, root: str):
        self.root = str(root)
        self.entries_dir = _fsio.join(self.root, "entries")
        self.probe_dir = _fsio.join(self.root, "probe")
        self.tmp_dir = _fsio.join(self.root, "tmp")
        self._lock = threading.Lock()
        self._queue: "queue.Queue" = queue.Queue()
        self._writer: Optional[threading.Thread] = None
        self._pending = 0
        self._drained = threading.Condition(self._lock)
        self._closed = False

    # ------------------------------------------------------------ probe --

    def tier_a_enabled(self, libraries=()) -> bool:
        """One verdict gates both directions (storing a fresh library, loading
        a stored one); a failing one turns tier A off with a one-time warning.
        ``libraries`` are the files a dynamic probe would load."""
        v = _probe.verdict(cache_dir=self.probe_dir, libraries=libraries)
        if not v.tier_a:
            _probe.warn_tier_a_disabled_once(v)
        return v.tier_a

    # ---------------------------------------------------------- metrics --

    def _hit(self, tier: str, digest: str, kind: str):
        _OBS.counter("warmstore_hits_total", "warm-store hits by tier", tier=tier).inc()
        _journal.emit({"event": "warmstore_hit", "tier": tier, "digest": digest,
                       "kind": kind})

    def _miss(self, reason: str, digest: str = "", kind: str = ""):
        _OBS.counter("warmstore_misses_total", "warm-store misses", reason=reason).inc()
        _journal.emit({"event": "warmstore_miss", "reason": reason, "digest": digest,
                       "kind": kind})

    def _update_bytes_gauge(self):
        _OBS.gauge("warmstore_bytes_total", "bytes on disk under the warm-store root").set(
            self._du())

    def _du(self) -> int:
        total = 0
        if not os.path.isdir(self.entries_dir):
            return 0
        for dirpath, _dirnames, filenames in os.walk(self.entries_dir):
            for fn in filenames:
                try:
                    total += os.path.getsize(os.path.join(dirpath, fn))
                except OSError:
                    pass
        return total

    # ------------------------------------------------------------- read --

    def _read_entry(self, key: dict, fname: str):
        """(blob, meta, digest) of ``key``'s committed ``fname`` after its
        checks, or None after a miss (quarantining what fails them)."""
        digest = _keys.digest(key)
        kind = str(key.get("kind", ""))
        entry = os.path.join(self.entries_dir, digest)
        meta_path = os.path.join(entry, "meta.json")
        if not os.path.isfile(meta_path):
            self._miss("absent", digest, kind)
            return None
        try:
            with open(meta_path, "rb") as f:
                meta = json.loads(f.read().decode("utf-8"))
            if meta.get("format") != META_FORMAT or \
                    _keys.canonical(meta.get("key", {})) != _keys.canonical(key):
                self._quarantine(entry, digest, "key mismatch")
                self._miss("invalid", digest, kind)
                return None
        except (OSError, ValueError, UnicodeDecodeError):
            self._quarantine(entry, digest, "unreadable meta")
            self._miss("corrupt", digest, kind)
            return None
        finfo = meta.get("files", {}).get(fname)
        if not finfo:
            self._miss("absent", digest, kind)
            return None
        try:
            blob = (self._load_tier_a if fname == TIER_A else _fsio.read_bytes)(
                os.path.join(entry, fname))
        except OSError:
            self._quarantine(entry, digest, f"{fname} unreadable")
            self._miss("corrupt", digest, kind)
            return None
        if len(blob) != int(finfo.get("size", -1)) or _crc(blob) != int(finfo.get("crc32", -1)):
            self._quarantine(entry, digest, f"{fname} checksum")
            self._miss("corrupt", digest, kind)
            return None
        return blob, meta, digest

    def consult(self, key: dict) -> Optional[Hit]:
        """Look up a step's record; validate its checksum and key identity.
        Any inconsistency quarantines the entry and reports a miss: the
        caller runs the step fresh, exactly as if the store were empty."""
        got = self._read_entry(key, TIER_B)
        if got is None:
            return None
        blob, meta, digest = got
        kind = str(key.get("kind", ""))
        try:
            record = json.loads(blob.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            self._miss("error", digest, kind)
            _journal.emit({"event": "warmstore_restore_error", "digest": digest,
                           "file": TIER_B, "error": f"{type(e).__name__}: {e}"})
            return None
        self._hit("b", digest, kind)
        return Hit("b", record, meta, digest)

    def _load_tier_a(self, path: str) -> bytes:
        """The one place a stored library's bytes are read (the tests' spy)."""
        return _fsio.read_bytes(path)

    def library_entry(self, filename: str) -> str:
        return os.path.join(self.entries_dir, _keys.digest(_keys.library_key(filename)))

    def restore_library(self, filename: str, dest) -> bool:
        """Tier A: write the stored ``filename`` to ``dest`` (temp + rename)
        after its checksum, under a passing probe verdict. False on a miss;
        a failed check quarantines the entry."""
        key = _keys.library_key(filename)
        stored = os.path.join(self.library_entry(filename), TIER_A)
        if not os.path.isfile(stored):
            self._miss("absent", _keys.digest(key), "library")
            return False
        # a verdict known to fail reads nothing; an unknown one is probed on
        # the stored file only after its checksum held
        if not self.tier_a_enabled():
            self._miss("tier_a_off", _keys.digest(key), "library")
            return False
        got = self._read_entry(key, TIER_A)
        if got is None:
            return False
        blob, _meta, digest = got
        if not self.tier_a_enabled(libraries=[stored]):
            self._miss("tier_a_off", digest, "library")
            return False
        tmp = f"{dest}.{os.getpid()}.{threading.get_ident()}.ws"
        _fsio.write_bytes(tmp, blob)
        _fsio.replace(tmp, dest)
        self._hit("a", digest, "library")
        return True

    def quarantine_library(self, filename: str, why: str) -> None:
        """A restored library that failed to load: out of the store."""
        entry = self.library_entry(filename)
        if os.path.isdir(entry):
            self._quarantine(entry, os.path.basename(entry), why)

    def _quarantine(self, entry: str, digest: str, why: str):
        dst = f"{entry}.corrupt"
        try:
            if os.path.isdir(dst):
                _fsio.rmtree(dst)
            _fsio.move(entry, dst)
        except OSError:
            _fsio.rmtree(entry)   # cannot rename: drop it outright
        _OBS.counter("warmstore_quarantined_total", "entries quarantined as .corrupt").inc()
        _journal.emit({"event": "warmstore_quarantine", "digest": digest, "reason": why})

    # ------------------------------------------------------------ write --

    def offer(self, key: dict, record: dict) -> bool:
        """Enqueue a step's record (tier B). Offers are idempotent; a rank
        other than 0 drops them."""
        return self._enqueue(key, lambda: {TIER_B: json.dumps(
            record, sort_keys=True, indent=1).encode("utf-8")})

    def offer_library(self, filename: str, path) -> bool:
        """Enqueue a fresh ``nvcc`` build for tier A. The writer thread reads
        the file and asks the probe first (off the step path): under a
        failing verdict nothing is stored."""
        path = str(path)

        def build():
            if not self.tier_a_enabled(libraries=[path]):
                return None
            return {TIER_A: _fsio.read_bytes(path)}
        return self._enqueue(_keys.library_key(filename), build)

    def _enqueue(self, key: dict, build: Callable[[], Optional[Dict[str, bytes]]]) -> bool:
        if self._closed or not self._is_writer_rank():
            return False
        if os.path.isdir(os.path.join(self.entries_dir, _keys.digest(key))):
            return False   # already committed
        with self._lock:
            self._pending += 1
            if self._writer is None:
                self._writer = threading.Thread(target=self._writer_loop, daemon=True,
                                                name="paddle-tpu-torch-warmstore-writer")
                self._writer.start()
        self._queue.put((dict(key), build))
        return True

    @staticmethod
    def _is_writer_rank() -> bool:
        import torch.distributed as dist
        return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0

    def _writer_loop(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            key, build = item
            try:
                blobs = build()
                if blobs:
                    self._write_entry(key, blobs)
            except Exception as e:   # a failed write is a non-event: the step ran
                _journal.emit({"event": "warmstore_write_error", "digest": _keys.digest(key),
                               "error": f"{type(e).__name__}: {e}"})
            finally:
                with self._drained:
                    self._pending -= 1
                    if self._pending <= 0:
                        self._drained.notify_all()

    def _write_entry(self, key: dict, blobs: Dict[str, bytes]):
        digest = _keys.digest(key)
        final = os.path.join(self.entries_dir, digest)
        if os.path.isdir(final):
            return
        _fsio.makedirs(self.tmp_dir)
        stage = os.path.join(self.tmp_dir, f"{digest}.{os.getpid()}.{threading.get_ident()}")
        _fsio.makedirs(stage)
        meta = {"format": META_FORMAT, "key": key, "created_unix": time.time(),
                "files": {name: {"size": len(blob), "crc32": _crc(blob)}
                          for name, blob in blobs.items()}}
        for name, blob in blobs.items():
            _fsio.write_bytes(os.path.join(stage, name), blob)
        # meta.json lands inside the staged dir; the dir rename commits
        _fsio.write_bytes(os.path.join(stage, "meta.json"),
                          json.dumps(meta, sort_keys=True, indent=1).encode("utf-8"))
        _fsio.makedirs(self.entries_dir)
        try:
            _fsio.move(stage, final)
        except OSError:
            _fsio.rmtree(stage)   # raced another writer: theirs won
            return
        _journal.emit({"event": "warmstore_write", "digest": digest,
                       "kind": str(key.get("kind", "")), "files": sorted(blobs),
                       "bytes": sum(map(len, blobs.values()))})
        self._update_bytes_gauge()
        # the chaos hook fires after the commit: the read side must catch it
        from ..resilience import faults as _rfaults
        if _rfaults._active:
            _rfaults.mutate_warmstore(final)

    def flush(self, timeout: float = 30.0) -> bool:
        """Wait for queued writes to land (tests, the end of a process; the
        step path never calls it)."""
        deadline = time.monotonic() + timeout
        with self._drained:
            while self._pending > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._drained.wait(remaining)
        return True

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            writer = self._writer
        if writer is not None:
            self._queue.put(None)
            writer.join(timeout=10.0)

    # ------------------------------------------------------- management --

    def _entry_dirs(self, include_corrupt: bool = False) -> List[str]:
        if not os.path.isdir(self.entries_dir):
            return []
        out = []
        for name in sorted(os.listdir(self.entries_dir)):
            if name.endswith(".corrupt") and not include_corrupt:
                continue
            p = os.path.join(self.entries_dir, name)
            if os.path.isdir(p):
                out.append(p)
        return out

    def ls(self) -> List[dict]:
        rows = []
        for entry in self._entry_dirs(include_corrupt=True):
            name = os.path.basename(entry)
            row = {"digest": name, "corrupt": name.endswith(".corrupt"), "kind": "",
                   "tiers": [], "bytes": 0, "mtime": 0.0}
            try:
                row["mtime"] = os.path.getmtime(entry)
                for fn in os.listdir(entry):
                    row["bytes"] += os.path.getsize(os.path.join(entry, fn))
                meta_path = os.path.join(entry, "meta.json")
                if os.path.isfile(meta_path):
                    with open(meta_path) as f:
                        meta = json.load(f)
                    row["kind"] = str(meta.get("key", {}).get("kind", ""))
                    row["tiers"] = sorted(n.split(".")[0][-1] for n in meta.get("files", {}))
            except (OSError, ValueError):
                row["corrupt"] = True
            rows.append(row)
        return rows

    def verify(self) -> List[str]:
        """Re-checksum every committed entry; report (not quarantine) what
        is wrong: the CLI's ``verify``."""
        problems = []
        for entry in self._entry_dirs(include_corrupt=True):
            name = os.path.basename(entry)
            if name.endswith(".corrupt"):
                problems.append(f"{name}: quarantined")
                continue
            try:
                with open(os.path.join(entry, "meta.json")) as f:
                    meta = json.load(f)
            except (OSError, ValueError) as e:
                problems.append(f"{name}: meta.json unreadable ({type(e).__name__})")
                continue
            if meta.get("format") != META_FORMAT:
                problems.append(f"{name}: meta format {meta.get('format')!r}")
                continue
            if _keys.digest(meta.get("key", {})) != name:
                problems.append(f"{name}: key does not hash to digest")
            for fname, finfo in sorted(meta.get("files", {}).items()):
                try:
                    blob = _fsio.read_bytes(os.path.join(entry, fname))
                except OSError:
                    problems.append(f"{name}/{fname}: missing")
                    continue
                if len(blob) != int(finfo.get("size", -1)):
                    problems.append(f"{name}/{fname}: size {len(blob)} != {finfo.get('size')}")
                elif _crc(blob) != int(finfo.get("crc32", -1)):
                    problems.append(f"{name}/{fname}: crc32 mismatch")
        return problems

    def gc(self, max_bytes: int) -> List[str]:
        """Evict oldest first until the store fits ``max_bytes``; quarantined
        entries go first whatever their age."""
        removed = []
        entries = []
        for entry in self._entry_dirs(include_corrupt=True):
            size = 0
            try:
                for fn in os.listdir(entry):
                    size += os.path.getsize(os.path.join(entry, fn))
                mtime = os.path.getmtime(entry)
            except OSError:
                mtime = 0.0
            entries.append((0 if entry.endswith(".corrupt") else 1, mtime, entry, size))
        total = sum(e[3] for e in entries)
        for _prio, _mtime, entry, size in sorted(entries):
            if total <= max_bytes:
                break
            _fsio.rmtree(entry)
            total -= size
            removed.append(os.path.basename(entry))
        if removed:
            _journal.emit({"event": "warmstore_gc", "removed": removed})
        self._update_bytes_gauge()
        return removed

    def records(self) -> List[dict]:
        """The committed steps' keys and records (read, not checked: the
        prefetch's hint; a consult checks what it serves)."""
        out = []
        for entry in self._entry_dirs():
            try:
                with open(os.path.join(entry, "meta.json")) as f:
                    meta = json.load(f)
                if TIER_B not in meta.get("files", {}):
                    continue
                with open(os.path.join(entry, TIER_B)) as f:
                    out.append({"key": meta.get("key", {}), "record": json.load(f)})
            except (OSError, ValueError):
                continue
        return out

    def prefetch(self) -> int:
        """One startup scan: parse every committed meta, then have the
        kernels that this card's stored steps launched ready before the first
        request, all together (``cuda_build.build``: each restored from tier
        A under a passing probe, else compiled by ``nvcc``). Returns the
        number of readable entries."""
        n = 0
        for entry in self._entry_dirs():
            try:
                with open(os.path.join(entry, "meta.json")) as f:
                    json.load(f)
                n += 1
            except (OSError, ValueError):
                continue
        kernels = set()
        import torch
        if torch.cuda.is_available():
            here = dict(_keys.versions(), device_kind=_keys.device_kind("cuda"))
            for r in self.records():
                if all(r["key"].get(k) == v for k, v in here.items()):
                    kernels.update(k["name"] for k in r["record"].get("kernels", []))
        if kernels:
            from ..core import cuda_build
            cuda_build.build(sorted(kernels))
        self._update_bytes_gauge()
        _journal.emit({"event": "warmstore_prefetch", "entries": n, "root": self.root,
                       "kernels": sorted(kernels)})
        return n
