"""Durable periodic checkpoint rotation and exact resume (the port's copy of
``paddle_tpu/utils/checkpointer.py``; reference:
python/paddle/fluid/incubate/checkpoint/auto_checkpoint.py).

Builds on ``io.save_persistables`` / ``load_persistables`` in the format
both packages share, so a directory saved by either restores in the other.
Rotation keeps ``max_to_keep`` steps; a LATEST marker is written last, and
``restore()`` treats it as a hint only: a missing, torn or stale marker
degrades to scanning ``ckpt-*`` for the newest step whose manifest and
chunk files are all present at their recorded sizes.

- **Integrity**: manifests record each chunk's byte size and crc32;
  ``restore()`` verifies every chunk it reads, and a corrupt checkpoint is
  quarantined (renamed ``ckpt-N.corrupt``, journaled ``ckpt_quarantine``)
  so the scan falls through to the newest complete step.
- **Async saves**: ``save(step, async_=True)`` (or ``async_save=True``)
  blocks only for the copy of the state to the host, made in the caller's
  thread (``io.snapshot_persistables``); writing, LATEST and rotation run
  on one writer thread that touches no tensor. Overlapping saves apply
  backpressure; a writer's error surfaces on the next ``save()`` /
  ``wait()``; ``wait()`` / ``close()`` flush.
- **Exact resume**: each checkpoint carries ``trainstate.json`` (step, the
  program's run counter, the dataset position and the stream watermark that
  ``StepGuardian.train_from_dataset`` stages); ``restore()`` sets the run
  counter and exposes ``.train_state``. The load writes into the scope's
  tensors in place (``io.load_vars``), so captured CUDA graphs replay on.
- **Observability**: ``checkpoint_blocked_seconds{mode}`` and
  ``checkpoint_write_seconds{mode}`` histograms, ``checkpoint_bytes_total``,
  ``checkpoint_corruption_total{kind}``; ``ckpt_save`` / ``ckpt_corrupt`` /
  ``ckpt_quarantine`` journal events.

Under a process group of several ranks (data parallel) a save is
synchronous: every rank writes its part (``io.save_vars``: rank 0 the
replicated state, each rank its ZeRO blocks, then a barrier), rank 0 writes
the train state and publishes ``LATEST``, and the ranks meet again; a
restore at the same world size reads each rank's part. Restoring at
another world size (the reshard) is ROADMAP item 13 (c). Host-resident
embedding tables (``ops/host_table.py``) are not part of a checkpoint, as
in the JAX package (ROADMAP fault 3.14): save them with
``host_table.save_all`` / ``load_all`` at the same boundary.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Optional

from . import fs as _fsio
from ..observability import journal as _journal
from ..observability.metrics import REGISTRY as _OBS
from ..parallel import env as _penv

TRAINSTATE_FILE = "trainstate.json"


def _program(p):
    """The Program a ``CompiledProgram`` wraps (a Program is its own)."""
    return getattr(p, "program", p) if hasattr(p, "dist_strategy") else p


class Checkpointer:
    """Usage::

        ck = Checkpointer(exe, program, "ckpts", save_interval_steps=100,
                          async_save=True)
        start = ck.restore() + 1          # -1 -> fresh run
        for step in range(start, n_steps):
            exe.run(...)
            ck.maybe_save(step)
        ck.close()                        # flush the pending async write
    """

    def __init__(self, exe, program, dirname: str,
                 save_interval_steps: int = 0, save_interval_secs: float = 0,
                 max_to_keep: int = 3, async_save: bool = False):
        self.exe = exe
        self.program = program
        self.dirname = dirname
        self.save_interval_steps = save_interval_steps
        self.save_interval_secs = save_interval_secs
        self.max_to_keep = max_to_keep
        self.async_save = bool(async_save)
        self.train_state: Optional[dict] = None   # set by restore()
        self._train_state: dict = {}              # pending, next save's doc
        self._last_save_t = time.time()
        self._last_save_step: Optional[int] = None
        self._restored_step: Optional[int] = None
        self._writer: Optional[threading.Thread] = None
        self._async_error: Optional[BaseException] = None

    def _step_dir(self, step) -> str:
        return _fsio.join(self.dirname, f"ckpt-{step}")

    # -- saving --------------------------------------------------------------

    def update_train_state(self, **kw):
        """Merge fields (dataset epoch/batch position, fuse_steps, ...)
        into the ``trainstate.json`` the NEXT save will write.  The step
        and rng counter are recorded automatically."""
        self._train_state.update(kw)

    def save(self, step: int, async_: Optional[bool] = None,
             train_state: Optional[dict] = None):
        """Write checkpoint ``ckpt-<step>``.

        Sync (default): blocks for the full serialize+write+rotate, exactly
        the historical layout plus the v2 manifest fields.  Async: blocks
        only for the copy to the host; a background writer thread does the
        rest.  A still-running previous async write is waited for first
        (backpressure), which is also where its error -- if any --
        surfaces."""
        from .. import io
        from ..resilience import faults as _rfaults
        async_ = self.async_save if async_ is None else bool(async_)
        if _penv.dist_world_size() > 1:
            async_ = False   # the ranks write their parts and meet at barriers
        self.wait()   # backpressure + surface the previous writer's error
        if train_state:
            self._train_state.update(train_state)
        if _rfaults._active:
            # fault site: transient checkpoint-write failure, injected
            # before any file is touched so the guardian's retry re-runs a
            # clean save (torn mid-write saves are separately covered by
            # the complete-step scanning in latest_step/_is_complete)
            _rfaults.fire("checkpoint_write", step)
        d = self._step_dir(step)
        ts_doc = self._trainstate_doc(step)
        t0 = time.perf_counter()
        if not async_:
            nbytes = io.save_persistables(self.exe, d, self.program)
            self._finish_save(step, d, ts_doc)
            dt = time.perf_counter() - t0
            for name in ("checkpoint_blocked_seconds",
                         "checkpoint_write_seconds"):
                _OBS.histogram(
                    name, "checkpoint save time by phase and mode",
                    mode="sync").observe(dt)
            self._note_saved(step, nbytes or 0, blocked=dt, write=dt,
                             async_=False)
            return
        # async: phase 1 (the copy to the host) is the only blocking part.
        # The ambient scope is resolved HERE, in the caller's thread -- the
        # scope stack is thread-local and the writer thread must never
        # consult its own -- and the writer gets numpy arrays only
        from ..core.executor import global_scope
        snap = io.snapshot_persistables(self.program, scope=global_scope())
        blocked = time.perf_counter() - t0
        _OBS.histogram("checkpoint_blocked_seconds",
                       "checkpoint save time by phase and mode",
                       mode="async").observe(blocked)
        self._writer = threading.Thread(
            target=self._write_async, args=(step, d, snap, ts_doc, blocked),
            name="checkpointer-writer", daemon=True)
        self._writer.start()
        # cadence advances at enqueue time: the save is logically taken at
        # this step; a failed write surfaces on the next save()/wait()
        self._last_save_t = time.time()
        self._last_save_step = step

    def _write_async(self, step, d, snap, ts_doc, blocked):
        from .. import io
        from ..resilience import faults as _rfaults
        t0 = time.perf_counter()
        try:
            nbytes = io.write_snapshot(snap, d)
            self._write_trainstate(d, ts_doc)
            if _rfaults._active:
                _rfaults.mutate_checkpoint(d, step)
            self._publish_and_rotate(step)
            write = time.perf_counter() - t0
            _OBS.histogram("checkpoint_write_seconds",
                           "checkpoint save time by phase and mode",
                           mode="async").observe(write)
            self._note_saved(step, nbytes, blocked=blocked, write=write,
                             async_=True)
        except BaseException as e:   # surfaces on the next save()/wait()
            self._async_error = e
            _journal.emit({"event": "ckpt_save_error", "step": step,
                           "error": f"{type(e).__name__}: {e}"})

    def _finish_save(self, step, d, ts_doc):
        """Post-chunk-write tail of a sync save: trainstate, fault hook,
        LATEST, rotation."""
        from ..resilience import faults as _rfaults
        if _penv.get_rank() == 0:
            self._write_trainstate(d, ts_doc)
            if _rfaults._active:
                _rfaults.mutate_checkpoint(d, step)
            self._publish_and_rotate(step)
        _penv.barrier("checkpoint_publish")
        self._last_save_t = time.time()
        self._last_save_step = step

    def _publish_and_rotate(self, step):
        """LATEST, then rotation."""
        with _fsio.open_file(_fsio.join(self.dirname, "LATEST.tmp"),
                             "w") as f:
            json.dump({"step": step, "time": time.time()}, f)
        _fsio.replace(_fsio.join(self.dirname, "LATEST.tmp"),
                      _fsio.join(self.dirname, "LATEST"))
        self._rotate()

    def _rotate(self):
        kept = sorted((int(n.split("-", 1)[1])
                       for n in _fsio.listdir(self.dirname)
                       if n.startswith("ckpt-") and
                       n.split("-", 1)[1].isdigit()), reverse=True)
        for old in kept[self.max_to_keep:]:
            if old == self._restored_step:
                # never rotate the step this process restored from: a
                # diagnostic reader may still be reading it
                continue
            _fsio.rmtree(self._step_dir(old), ignore_errors=True)

    def _trainstate_doc(self, step) -> dict:
        counter = 0
        if self.program is not None:
            counter = int(getattr(_program(self.program), "_rng_run_counter", 0))
        world = _penv.dist_world_size()
        doc = {"format_version": 1, "step": int(step),
               "rng_counter": counter,
               # the world this state was saved under (the JAX package's
               # elastic resume reads it)
               "world": {"nranks": world, "ndev": world}}
        doc.update(self._train_state)
        return doc

    def _write_trainstate(self, d, doc):
        with _fsio.open_file(_fsio.join(d, TRAINSTATE_FILE), "w") as f:
            json.dump(doc, f)

    def _note_saved(self, step, nbytes, blocked, write, async_):
        _OBS.counter("checkpoint_bytes_total",
                     "chunk bytes written by checkpoint saves").inc(nbytes)
        _journal.emit({"event": "ckpt_save", "step": step,
                       "async": bool(async_), "bytes": int(nbytes),
                       "blocked_ms": round(blocked * 1e3, 3),
                       "write_ms": round(write * 1e3, 3)})

    def wait(self):
        """Block until the in-flight async write (if any) lands; re-raise
        its error here if it failed.  Idempotent."""
        t = self._writer
        if t is not None:
            t.join()
            self._writer = None
        e, self._async_error = self._async_error, None
        if e is not None:
            # the enqueued save never landed: invalidate the cadence so
            # maybe_save fires again promptly and -- critically -- so the
            # guardian's emergency exit re-saves the step it would
            # otherwise believe is already on disk
            self._last_save_step = None
            raise e

    def close(self):
        """Flush the pending async write (errors surface here)."""
        self.wait()

    def maybe_save(self, step: int, train_state: Optional[dict] = None):
        due_steps = (self.save_interval_steps and
                     (self._last_save_step is None or
                      step - self._last_save_step >= self.save_interval_steps))
        due_secs = (self.save_interval_secs and
                    time.time() - self._last_save_t >= self.save_interval_secs)
        if due_steps or due_secs:
            self.save(step, train_state=train_state)

    # -- scanning ------------------------------------------------------------

    def _is_complete(self, d: str) -> bool:
        """True when ``d`` holds a finished save: every manifest the
        save promised parses and every chunk file they list is present AT
        ITS RECORDED BYTE SIZE (``io.verify_checkpoint(level="size")``).
        A zero-byte or truncated chunk must NOT count as a resume point.
        Pre-v2 manifests (no recorded sizes) fall back to the existence
        check."""
        from .. import io as _io
        return _io.verify_checkpoint(d, level="size")["ok"]

    def _complete_steps(self):
        """Yield the steps of complete ``ckpt-*`` dirs, newest first.
        Lazy: completeness costs one exists()+stat per chunk file (remote
        round-trips), and the caller usually wants only the newest.
        Quarantined ``ckpt-N.corrupt`` dirs never parse as steps."""
        try:
            names = _fsio.listdir(self.dirname)
        except (OSError, FileNotFoundError):
            return
        steps = set()
        for n in names:
            if n.startswith("ckpt-"):
                try:
                    steps.add(int(n.split("-", 1)[1]))
                except ValueError:
                    continue
        for s in sorted(steps, reverse=True):
            if self._is_complete(self._step_dir(s)):
                yield s

    def latest_step(self) -> int:
        """Step of the newest *complete* checkpoint, or -1.

        The LATEST pointer is the fast path; a missing, torn or corrupt
        LATEST (or one naming an incomplete/deleted/quarantined step dir --
        the remote-store crash window of ``fs.replace``, ADVICE r5)
        degrades to scanning the ``ckpt-*`` dirs for the newest step whose
        manifests and chunk files are all present at their recorded sizes.

        """
        path = _fsio.join(self.dirname, "LATEST")
        step = None
        try:
            if _fsio.exists(path):
                with _fsio.open_file(path) as f:
                    step = int(json.load(f)["step"])
        except (OSError, ValueError, KeyError, TypeError):
            step = None
        if step is not None and self._is_complete(self._step_dir(step)):
            return step
        for s in self._complete_steps():
            return s
        return -1

    # -- restoring -----------------------------------------------------------

    def quarantine(self, step: int, reason: str = "", kind: str = "crc"):
        """Move ``ckpt-<step>`` out of the resume scan's namespace
        (``ckpt-<step>.corrupt``) so ``latest_step()`` falls through to
        the next complete step.  The damaged tree is kept, not deleted --
        it is forensic evidence, and a doctor can still ``verify`` it."""
        src = self._step_dir(step)
        dst = f"{src}.corrupt"
        n = 1
        while _fsio.exists(dst):
            n += 1
            dst = f"{src}.corrupt.{n}"
        try:
            _fsio.move(src, dst)
            moved = True
        except OSError:
            moved = False   # another process won the rename race
        _OBS.counter("checkpoint_quarantine_total",
                     "corrupt checkpoints quarantined").inc()
        _journal.emit({"event": "ckpt_quarantine", "step": step,
                       "kind": kind, "to": dst if moved else None,
                       "reason": reason[:300]})
        return dst if moved else None

    def restore(self, program=None, step: Optional[int] = None) -> int:
        """Load the newest complete checkpoint; returns its step or -1.

        Every chunk read is checksum-verified against the v2 manifest; a
        corrupt checkpoint is quarantined (renamed ``ckpt-N.corrupt``,
        journaled) and the scan falls through to the next complete step.
        On success the program's rng run counter is rewound to the saved
        value and ``.train_state`` holds the checkpoint's
        ``trainstate.json`` (dataset position for exact resume).

        ``step`` pins an EXACT checkpoint step instead of the newest
        (forensic re-runs): a missing or corrupt pinned step raises instead
        of falling through."""
        from .. import io
        target = program or self.program
        if step is not None:
            d = self._step_dir(step)
            if not self._is_complete(d):
                raise FileNotFoundError(
                    f"checkpoint ckpt-{step} at {self.dirname} is "
                    f"missing or incomplete (restore(step={step}) "
                    f"does not fall through)")
            io.load_persistables(self.exe, d, target)
            self._apply_trainstate(d, target)
            self._last_save_step = step
            self._restored_step = step
            return step
        prev = None
        while True:
            step = self.latest_step()
            if step < 0:
                return -1
            if step == prev:
                # quarantine didn't take (shared store race / permissions):
                # re-raising beats spinning on the same corrupt step
                raise io.CheckpointCorruption(
                    f"checkpoint ckpt-{step} is corrupt and could not be "
                    f"quarantined; remove it from {self.dirname} manually",
                    kind="crc", path=self._step_dir(step))
            prev = step
            d = self._step_dir(step)
            try:
                io.load_persistables(self.exe, d, target)
            except io.CheckpointCorruption as err:
                self.quarantine(step, kind=err.kind, reason=str(err))
                continue
            self._apply_trainstate(d, target)
            self._last_save_step = step
            self._restored_step = step
            return step

    def _apply_trainstate(self, d, program):
        """Read ``trainstate.json`` (absent on old checkpoints) and
        set the program's run counter, so the restored run's next step
        draws what the uninterrupted run's would (the executor writes it to
        the card before each run)."""
        self.train_state = None
        path = _fsio.join(d, TRAINSTATE_FILE)
        try:
            if not _fsio.exists(path):
                return
            with _fsio.open_file(path) as f:
                doc = json.load(f)
            counter = doc.get("rng_counter")
        except (OSError, ValueError, KeyError, TypeError) as e:
            import warnings
            warnings.warn(f"unreadable {path}: {type(e).__name__}: {e}; "
                          f"resuming without exact train state", UserWarning)
            return
        self.train_state = doc
        if counter is not None and program is not None:
            _program(program)._rng_run_counter = int(counter)
