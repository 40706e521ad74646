"""Step guardian: retry / skip / rollback / preemption-safe training (the
port's copy of ``paddle_tpu/resilience/recovery.py``).

The recovery layer between :class:`~paddle_tpu_torch.core.executor.Executor`
and the checkpoint machinery.  ``StepGuardian`` wraps ``Executor.run``
(and ``train_from_dataset``) with four protections, each off-by-default-
cheap (a guardian built with defaults adds no file I/O, no signal
handlers, no threads, and no snapshot copies -- pinned by a guard test):

- **Nonfinite-step policy** ``skip|rollback|raise`` consuming the tensor-
  health watchdog verdict (``observability.health``): ``skip`` drops the
  bad update by restoring the pre-step snapshot (snapshot cadence is
  forced to every step) and continues; ``rollback`` restores the newest
  entry of a bounded in-memory ring of known-good host snapshots taken
  every ``snapshot_interval`` steps, falling back to
  ``Checkpointer.restore()`` when the ring is empty; ``raise`` (default)
  raises ``FloatingPointError``.
- **Bounded exponential-backoff retry with jitter** for transient errors:
  injected ``TransientFault``s, OSError (IO), and runtime errors carrying
  RESOURCE_EXHAUSTED / UNAVAILABLE / DEADLINE_EXCEEDED / ABORTED markers.
  The program's per-run rng counter is rewound before each retry so the
  replayed step is deterministic.
- **Hung-step deadline** (``step_timeout`` seconds > 0): the step runs in
  a worker thread and a hang past the deadline raises a clean
  :class:`StepTimeout` in the caller instead of blocking forever.
  Timeouts are NOT retried -- the hung dispatch may still hold the device,
  so the clean raise hands over to whatever restarts the process.
- **Preemption-safe checkpointing**: SIGTERM/SIGINT set a flag (handlers
  are installed only when a checkpointer is attached, and restored on
  close); at the next step boundary the guardian performs an emergency
  ``Checkpointer.save``, journals a ``preempt`` event, closes the
  executor, and raises :class:`Preempted` -- the run resumes from
  ``Checkpointer.restore()``.  A torn emergency save degrades safely: the
  checkpointer's complete-step scanning ignores it.

Counters: ``step_retries_total{site}``, ``steps_skipped_total``,
``rollback_total``, ``preemption_saves_total``; journal events ``retry`` /
``skip`` / ``rollback`` / ``preempt``.

Snapshots are host copies of the scope's tensors (dtype kept), taken in the
caller's thread after the step's work. A restore (a snapshot or
``Checkpointer.restore``) copies into the scope's tensors in place and
rebinds nothing, so the executor's captured CUDA graphs, which read those
tensors at fixed addresses, replay on without a recapture. The run counter
the guardian rewinds is the program's host integer; the executor writes it
into the counter on the card before every run, so a retried or restored
step draws the same dropout masks.
"""
from __future__ import annotations

import collections
import random
import signal as _signal
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..observability import blackbox as _blackbox
from ..observability import health as _health
from ..observability import journal as _journal
from ..observability.metrics import REGISTRY as _OBS
from . import faults as _faults


class Preempted(RuntimeError):
    """Raised by the guardian at a step boundary after a preemption request;
    ``saved_step`` is the emergency checkpoint's step (None without a
    checkpointer)."""

    def __init__(self, msg: str, step: Optional[int] = None,
                 saved_step: Optional[int] = None):
        super().__init__(msg)
        self.step = step
        self.saved_step = saved_step


class StepTimeout(RuntimeError):
    """A guarded step exceeded ``step_timeout`` seconds (hung d2h sync /
    collective); raised cleanly instead of hanging the training loop."""


#: substrings that mark a runtime error as transient/retryable
TRANSIENT_MARKERS = ("RESOURCE_EXHAUSTED", "UNAVAILABLE",
                     "DEADLINE_EXCEEDED", "ABORTED")


def is_transient(exc: BaseException) -> bool:
    """Is ``exc`` a transient (retry-worthy) failure?  Injected transient
    faults and OSError are; StepTimeout / Preempted / FloatingPointError
    never are (they have their own recovery paths); anything else is
    classified by the gRPC-style status markers in its message."""
    if isinstance(exc, _faults.TransientFault):
        return True
    if isinstance(exc, (StepTimeout, Preempted, FloatingPointError)):
        return False
    if isinstance(exc, OSError):
        return True
    s = str(exc)
    return any(m in s for m in TRANSIENT_MARKERS)


def transient_site(exc: BaseException) -> str:
    """Retry-counter label for a transient error."""
    if isinstance(exc, _faults.TransientFault):
        return exc.site or "dispatch"
    if isinstance(exc, OSError):
        return "io"
    return "dispatch"


# -- preemption flag + signal handlers --------------------------------------

_preempt = threading.Event()
_preempt_reason: Optional[str] = None
_prev_handlers: Optional[dict] = None
# refcount for nested installs: two live guardians each "install", and the
# handlers must survive until the LAST one uninstalls (closing one guardian
# must not strip SIGTERM routing from its sibling)
_install_count = 0


def backoff_delay(attempt: int, base: float, cap: float,
                  rng=random) -> float:
    """Exponential backoff with jitter: attempt N (1-based) waits
    ``min(cap, base * 2**(N-1))`` scaled by a jitter draw in [0.5x, 1.5x)
    -- shared by the step guardian and the stream readers."""
    delay = min(cap, base * (2 ** (attempt - 1)))
    return delay * (0.5 + rng.random())


def request_preemption(reason: str = "requested"):
    """Set the process-wide preemption flag (signal handler, injected
    ``preempt`` fault, or external orchestration code)."""
    global _preempt_reason
    if not _preempt.is_set():
        _preempt_reason = reason
        _preempt.set()


def preemption_requested() -> bool:
    return _preempt.is_set()


def clear_preemption():
    """Reset the flag (tests / in-process resume after a simulated
    preemption; a real preemption ends the process)."""
    global _preempt_reason
    _preempt_reason = None
    _preempt.clear()


def _on_signal(signum, frame):
    request_preemption(f"signal {signum}")


def install_signal_handlers(signals: Sequence[int] = (
        _signal.SIGTERM, _signal.SIGINT)) -> bool:
    """Route SIGTERM/SIGINT to the preemption flag. Refcounted: each call
    takes a share of the one installed handler set, and the previous
    handlers are restored only when the LAST holder calls
    :func:`uninstall_signal_handlers` (so closing one guardian never
    strips preemption routing from a sibling). Returns False (and
    installs nothing) off the main thread, where CPython forbids
    signal()."""
    global _prev_handlers, _install_count
    if _prev_handlers is not None:
        _install_count += 1
        return True
    prev = {}
    try:
        for s in signals:
            prev[s] = _signal.signal(s, _on_signal)
    except ValueError:  # not the main thread: roll back what we grabbed
        for s, h in prev.items():
            _signal.signal(s, h)
        return False
    _prev_handlers = prev
    _install_count = 1
    return True


def uninstall_signal_handlers(force: bool = False):
    """Drop one install_signal_handlers() share; the previous handlers
    come back when the count hits zero (``force=True`` restores
    immediately -- test teardown)."""
    global _prev_handlers, _install_count
    if _prev_handlers is None:
        return
    _install_count -= 1
    if _install_count > 0 and not force:
        return
    for s, h in _prev_handlers.items():
        try:
            _signal.signal(s, h)
        except (ValueError, OSError):
            pass
    _prev_handlers = None
    _install_count = 0


# -- the guardian -----------------------------------------------------------

_Snapshot = collections.namedtuple("_Snapshot", "step counter state")

POLICIES = ("skip", "rollback", "raise")


class StepGuardian:
    """Guarded front door over an Executor. Usage::

        ck = Checkpointer(exe, main, "ckpts", save_interval_steps=100)
        start = ck.restore() + 1
        g = resilience.StepGuardian(exe, main, checkpointer=ck,
                                    nonfinite_policy="skip",
                                    start_step=max(start, 0))
        for step in range(max(start, 0), n_steps):
            loss, = g.run(feed=next_batch(), fetch_list=[loss_var])

    ``g.run`` performs one guarded step: retry on transient errors, apply
    the nonfinite policy, checkpoint via ``checkpointer.maybe_save``, and
    exit resumably (``Preempted``) at the first step boundary after a
    SIGTERM/SIGINT or injected preemption.
    """

    def __init__(self, exe, program=None, *, checkpointer=None, scope=None,
                 nonfinite_policy: str = "raise",
                 snapshot_interval: int = 1, snapshot_ring: int = 2,
                 max_retries: int = 3, retry_backoff: float = 0.05,
                 retry_backoff_max: float = 2.0,
                 retry_seed: Optional[int] = None,
                 step_timeout: float = 0.0,
                 handle_signals: Optional[bool] = None,
                 start_step: int = 0):
        if nonfinite_policy not in POLICIES:
            raise ValueError(f"nonfinite_policy must be one of {POLICIES}, "
                             f"got {nonfinite_policy!r}")
        if snapshot_interval < 1:
            raise ValueError("snapshot_interval must be >= 1")
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        self.exe = exe
        self.program = program
        self.scope = scope
        self.checkpointer = checkpointer
        self.nonfinite_policy = nonfinite_policy
        # skip semantics ("drop THIS update") need the pre-step state, i.e.
        # a snapshot every step; rollback honors the configured cadence
        self.snapshot_interval = 1 if nonfinite_policy == "skip" \
            else snapshot_interval
        self.max_retries = max_retries
        self.retry_backoff = retry_backoff
        self.retry_backoff_max = retry_backoff_max
        self.step_timeout = step_timeout
        self.step = start_step
        self._rng = random.Random(retry_seed)
        self._ring: "collections.deque[_Snapshot]" = collections.deque(
            maxlen=max(1, snapshot_ring))
        self._last_snap_step: Optional[int] = None
        # dataset position staged by train_from_dataset for the step ABOUT
        # to run; applied to the checkpointer only after that step commits
        # (an emergency save at the pre-step boundary must persist the
        # LAST COMPLETED position, not the one that never ran)
        self._pending_state: Optional[dict] = None
        self._closed = False
        if handle_signals is None:
            handle_signals = checkpointer is not None
        self._signals_installed = bool(handle_signals) and \
            install_signal_handlers()

    # -- public -------------------------------------------------------------

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy: bool = True, **kw) -> list:
        """One guarded ``Executor.run`` step; returns its fetches."""
        if self._closed:
            raise RuntimeError("StepGuardian is closed")
        from ..core.executor import global_scope
        from ..framework import default_main_program
        program = program or self.program or default_main_program()
        scope = scope or self.scope or global_scope()
        # take ownership of the staged dataset position NOW: if this step
        # raises (preemption, terminal error), the stale doc must never
        # be committed by a later, unrelated run() call
        pending_state = self._take_pending_state()
        if _preempt.is_set():
            self._emergency_exit()  # raises Preempted
        if self.nonfinite_policy != "raise" and self._snapshot_due():
            self._take_snapshot(program, scope)
        pre_counter = getattr(program, "_rng_run_counter", 0)
        # the label the executor's health check stashes verdicts under;
        # verdict reads are filtered by it so a sibling guardian's step
        # never consumes (or loses) this program's finding
        label = f"{id(program)}:v{getattr(program, '_version', 0)}"
        _health.take_verdict(label)  # drop OUR stale verdict, if any
        attempt = 0
        while True:
            try:
                fetches = self._attempt(program, feed, fetch_list, scope,
                                        return_numpy, kw)
                bad = self._verdict(fetch_list, fetches, label)
                break
            except FloatingPointError as e:
                # the env-armed health watchdog (raise mode) or
                # FLAGS_check_nan_inf fired inside the step: the update is
                # already committed to the Scope -- same recovery as a
                # verdict on the returned fetches. The real fetch values
                # died with the raise, so under skip/rollback the caller
                # gets scalar-NaN placeholders, one per requested fetch --
                # `loss, = g.run(...)` keeps unpacking either way.
                v = _health.take_verdict(label)
                bad = list((v or {}).get("vars") or [])[:8] or \
                    [str(e)[:120]]
                fetches = [np.full((), np.nan, np.float32)
                           for _ in (fetch_list or [])]
                break
            except Preempted:
                raise
            except Exception as e:
                if not is_transient(e) or attempt >= self.max_retries:
                    _blackbox.maybe_write(
                        "retries_exhausted" if is_transient(e)
                        else "terminal_error", error=e,
                        extra={"step": self.step, "attempt": attempt,
                               "program": label})
                    raise
                attempt += 1
                self._backoff(attempt, transient_site(e), e)
                # deterministic replay: the failed attempt may have
                # consumed the program's rng-run counter
                try:
                    program._rng_run_counter = pre_counter
                except AttributeError:
                    pass
        if bad:
            fetches = self._apply_nonfinite_policy(bad, program, scope,
                                                   fetches)
        self.step += 1
        self._commit_train_state(pending_state)
        if self.checkpointer is not None:
            self._checkpoint_with_retry(self.checkpointer.maybe_save,
                                        self.step - 1)
        return fetches

    def run_fused(self, program=None, feeds=None, fetch_list=None,
                  scope=None, stacked_feed=None, return_numpy: bool = True,
                  **kw) -> list:
        """K guarded steps as one ``Executor.run_fused`` call (on the card, K
        replays of the step's graph).

        Recovery granularity is the K-step call: snapshots land at its
        boundaries, so ``skip`` drops -- and ``rollback`` rewinds -- all K
        substeps as a unit (K batches consumed on skip, the rng counter
        rewound by K on rollback); a nonfinite substep cannot be excised
        individually from a fused update.  ``return_numpy`` defaults to
        True here (unlike the executor's lazy fused default): the
        guardian's own nonfinite scan needs host values when the env
        watchdog is off."""
        if self._closed:
            raise RuntimeError("StepGuardian is closed")
        from ..core.executor import global_scope
        from ..framework import default_main_program
        program = program or self.program or default_main_program()
        scope = scope or self.scope or global_scope()
        if stacked_feed is not None:
            k = int(np.shape(next(iter(stacked_feed.values())))[0])
        else:
            k = len(feeds or ())
        if k < 1:
            raise ValueError("run_fused needs at least one feed")
        pending_state = self._take_pending_state()
        if _preempt.is_set():
            self._emergency_exit()  # raises Preempted
        if self.nonfinite_policy != "raise" and self._snapshot_due():
            self._take_snapshot(program, scope)
        pre_counter = getattr(program, "_rng_run_counter", 0)
        label = f"{id(program)}:v{getattr(program, '_version', 0)}"
        _health.take_verdict(label)  # drop OUR stale verdict, if any
        call = lambda: self.exe.run_fused(  # noqa: E731
            program, feeds=feeds, stacked_feed=stacked_feed,
            fetch_list=fetch_list, scope=scope, return_numpy=return_numpy,
            **kw)
        attempt = 0
        while True:
            try:
                fetches = self._attempt_call(call)
                bad = self._verdict(fetch_list, fetches, label,
                                    watchdog_covered=True)
                break
            except FloatingPointError as e:
                # watchdog raise-mode fired inside the K steps: placeholder
                # rows, one (K,)-shaped NaN vector per requested fetch, so
                # unpacking matches the stacked contract either way
                v = _health.take_verdict(label)
                bad = list((v or {}).get("vars") or [])[:8] or \
                    [str(e)[:120]]
                fetches = [np.full((k,), np.nan, np.float32)
                           for _ in (fetch_list or [])]
                break
            except Preempted:
                raise
            except Exception as e:
                if not is_transient(e) or attempt >= self.max_retries:
                    _blackbox.maybe_write(
                        "retries_exhausted" if is_transient(e)
                        else "terminal_error", error=e,
                        extra={"step": self.step, "attempt": attempt,
                               "program": label, "fused_k": k})
                    raise
                attempt += 1
                self._backoff(attempt, transient_site(e), e)
                try:
                    program._rng_run_counter = pre_counter
                except AttributeError:
                    pass
        if bad:
            fetches = self._apply_nonfinite_policy(bad, program, scope,
                                                   fetches)
        self.step += k
        self._commit_train_state(pending_state)
        if self.checkpointer is not None:
            self._checkpoint_with_retry(self.checkpointer.maybe_save,
                                        self.step - 1)
        return fetches

    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread: int = 0, fetch_list=None,
                           fuse_steps: int = 1, skip_batches: int = 0,
                           epoch: int = 0, step_cb=None, **kw):
        """One guarded epoch over a Dataset (each batch through
        :meth:`run`, prefetched like ``Executor.train_from_dataset``).

        ``fuse_steps=K`` runs the epoch in guarded K-step calls
        (:meth:`run_fused`; the trailing partial chunk through :meth:`run`)
        -- documented skip/rollback granularity becomes K steps. A program
        that cannot run fused (a host-table program, one that is not
        captured) warns and runs unfused, as the executor's loop does.
        ``fuse_steps=0`` reads the autotuner's cached ``fuse_steps.k``
        decision (1 without one; the guardian never searches: measurement
        belongs to the unguarded loop).  ``step_cb(batches_consumed,
        fetches)`` is
        invoked after every guarded chunk (per-step loss collection
        without materializing more than the caller asks for).

        Exact resume: the attached checkpointer's ``trainstate.json``
        records, for every guarded step, the batch position the save at
        that step boundary corresponds to (``epoch``, ``batch`` = batches
        consumed including the step that just ran, ``fuse_steps``) --
        staged when the chunk arrives, committed only after the step
        lands, so an emergency preemption save never persists the
        position of a step that never ran.  ``skip_batches=N``
        fast-forwards a restored run past the batches the checkpoint
        already consumed::

            start = ck.restore() + 1
            pos = ck.train_state or {}
            g.train_from_dataset(dataset=ds, fuse_steps=k,
                                 epoch=pos.get("epoch", 0),
                                 skip_batches=pos.get("batch", 0))

        A streaming dataset (``paddle_tpu_torch.data.StreamingDataset``)
        additionally rides its per-source watermark in the same document
        (``stream`` key, from ``dataset.watermark(batch)``): restore with
        ``ds.seek(ck.train_state["stream"])`` instead of
        ``skip_batches``."""
        if dataset is None:
            raise ValueError("train_from_dataset needs a dataset")
        depth = self.exe._prefetch_depth(thread, dataset)
        k = int(fuse_steps)
        batches = dataset._iter_batches()
        # the stream-abort hook, captured before islice/chain wrapping
        # can hide it from the prefetch loop's wind-down
        abort_cb = getattr(batches, "abort", None)
        if skip_batches:
            import itertools
            batches = itertools.islice(batches, skip_batches, None)
        if k == 0:
            # the cached fuse_steps.k decision (or 1): the guardian never
            # searches, measurement belongs to the unguarded loop
            k, batches, _ = self.exe._resolve_fuse_steps(batches, fetch_list or [])
        consumed = int(skip_batches)
        mark = getattr(self.checkpointer, "update_train_state", None)
        wm = getattr(dataset, "watermark", None)

        def _mark(n_after: int):
            # STAGED before the step runs, committed by run()/run_fused()
            # after the state lands (see _commit_train_state): the
            # position a save persists is "this chunk consumed", and a
            # pre-step emergency exit keeps the previous one
            if mark is None:
                return
            st = {"epoch": int(epoch), "batch": n_after, "fuse_steps": k}
            if wm is not None:
                doc = wm(n_after)
                if doc is not None:
                    st["stream"] = doc
            self._pending_state = st
        if k > 1:
            from ..framework import default_main_program
            prog = program or self.program or default_main_program()
            reason = self.exe._fuse_ineligible(prog)
            if reason is not None:
                import warnings
                warnings.warn(
                    f"StepGuardian.train_from_dataset(fuse_steps="
                    f"{fuse_steps}): {reason}; running unfused",
                    stacklevel=2)
                k = 1
        last = None
        if k > 1:
            for item in self.exe._prefetch_batches(batches, depth, fuse=k,
                                                   abort=abort_cb):
                if item[0] == "mega":
                    _mark(consumed + item[2])
                    last = self.run_fused(program, stacked_feed=item[1],
                                          fetch_list=fetch_list,
                                          scope=scope, **kw)
                    consumed += item[2]
                else:
                    _mark(consumed + 1)
                    last = self.run(program, feed=item[1],
                                    fetch_list=fetch_list, scope=scope,
                                    **kw)
                    consumed += 1
                if step_cb is not None:
                    step_cb(consumed, last)
        else:
            for feed in self.exe._prefetch_batches(batches, depth,
                                                   abort=abort_cb):
                _mark(consumed + 1)
                last = self.run(program, feed=feed, fetch_list=fetch_list,
                                scope=scope, **kw)
                consumed += 1
                if step_cb is not None:
                    step_cb(consumed, last)
        return last

    def close(self):
        """Release signal handlers and close the executor. Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._signals_installed:
            uninstall_signal_handlers()
            self._signals_installed = False
        self.exe.close()

    # -- internals ----------------------------------------------------------

    def _attempt(self, program, feed, fetch_list, scope, return_numpy, kw):
        call = lambda: self.exe.run(  # noqa: E731
            program, feed=feed, fetch_list=fetch_list, scope=scope,
            return_numpy=return_numpy, **kw)
        return self._attempt_call(call)

    def _attempt_call(self, call):
        if not self.step_timeout:
            return call()
        # hung-step watchdog: the step (incl. its d2h sync) runs in a
        # worker thread; a hang past the deadline raises StepTimeout here
        # while the daemon worker stays parked on the dead dispatch
        result: dict = {}
        done = threading.Event()

        def worker():
            try:
                result["value"] = call()
            except BaseException as e:  # re-raised in the caller below
                result["error"] = e
            finally:
                done.set()

        t = threading.Thread(target=worker, daemon=True,
                             name="resilience-step")
        t.start()
        if not done.wait(self.step_timeout):
            _journal.emit({"event": "step_timeout", "step": self.step,
                           "deadline_s": self.step_timeout})
            _blackbox.maybe_write("step_timeout",
                                  extra={"step": self.step,
                                         "deadline_s": self.step_timeout})
            raise StepTimeout(
                f"step {self.step} exceeded the {self.step_timeout}s "
                f"deadline (hung dispatch/d2h sync); restart from the "
                f"latest checkpoint")
        if "error" in result:
            raise result["error"]
        return result["value"]

    def _backoff(self, attempt: int, site: str, exc: BaseException):
        delay = backoff_delay(attempt, self.retry_backoff,
                              self.retry_backoff_max, self._rng)
        _OBS.counter("step_retries_total",
                     "guarded-step retries of transient errors by site",
                     site=site).inc()
        _journal.emit({"event": "retry", "site": site, "step": self.step,
                       "attempt": attempt,
                       "backoff_ms": round(delay * 1e3, 1),
                       "error": str(exc)[:200]})
        time.sleep(delay)

    def _verdict(self, fetch_list, fetches, label,
                 watchdog_covered: bool = False) -> List[str]:
        """Nonfinite tensor names for this step: the health watchdog's
        stashed verdict when the env gate is armed (filtered to this
        program's label), else the guardian's own scan of the returned
        fetches (free when they are already host numpy; skipped under
        policy=raise for tensor fetches, where it would add a copy to the
        host the user did not opt into).

        ``watchdog_covered`` (the fused path): the armed watchdog already
        checked each of the K steps' fetches, so an empty stash is the
        clean verdict."""
        v = _health.take_verdict(label)
        if v is not None:
            return list(v.get("vars") or [])
        if watchdog_covered and _health.mode() != "off":
            return []
        if not fetch_list or fetches is None:
            return []
        from ..framework import Variable
        names = [f.name if isinstance(f, Variable) else str(f)
                 for f in fetch_list]
        named = list(zip(names, fetches))
        if self.nonfinite_policy == "raise" and \
                not all(isinstance(val, np.ndarray) for _, val in named):
            return []
        return _health.nonfinite_names(named)

    def _apply_nonfinite_policy(self, bad: List[str], program, scope,
                                fetches):
        policy = self.nonfinite_policy
        if policy == "raise":
            err = FloatingPointError(
                f"nonfinite step {self.step}: {bad[:8]} "
                f"(StepGuardian nonfinite_policy=raise)")
            _blackbox.maybe_write("nonfinite", error=err,
                                  extra={"step": self.step,
                                         "vars": bad[:8]})
            raise err
        # skip drops the update but keeps marching (the batch is consumed,
        # the next step draws fresh rng); rollback is a true rewind, so the
        # rng-run counter is restored too and the replay is deterministic
        to_step, source = self._restore(program, scope,
                                        restore_counter=(policy != "skip"))
        if policy == "skip":
            _OBS.counter("steps_skipped_total",
                         "nonfinite steps whose update was dropped").inc()
            _journal.emit({"event": "skip", "step": self.step,
                           "vars": bad[:8], "restored_step": to_step,
                           "source": source})
        else:
            _OBS.counter("rollback_total",
                         "state rollbacks to a known-good snapshot").inc()
            _journal.emit({"event": "rollback", "step": self.step,
                           "vars": bad[:8], "to_step": to_step,
                           "source": source})
        return fetches

    def _take_pending_state(self):
        """Pop the dataset position ``train_from_dataset`` staged for the
        step about to run: the step that takes it either commits it on
        success or drops it on failure -- never a later unrelated run."""
        pending, self._pending_state = self._pending_state, None
        return pending

    def _commit_train_state(self, pending):
        """Apply the staged dataset position to the checkpointer, now
        that the step it described has landed."""
        if pending is not None and self.checkpointer is not None:
            self.checkpointer.update_train_state(**pending)

    def _snapshot_due(self) -> bool:
        return (self._last_snap_step is None or
                self.step - self._last_snap_step >= self.snapshot_interval)

    def _take_snapshot(self, program, scope):
        """Host copies of the program's persistable state (+ the rng-run
        counter, so a restored step replays the same randomness). The
        copies keep each tensor's dtype; they live on the host, so the next
        step's in-place update does not reach them."""
        from ..core.executor import host_copy
        state = {}
        for name, var in program.global_block().vars.items():
            if not var.persistable:
                continue
            val = scope.find_var(name)
            if val is None:
                continue
            state[name] = host_copy(val)
        self._ring.append(_Snapshot(
            self.step, getattr(program, "_rng_run_counter", 0), state))
        self._last_snap_step = self.step

    def _restore(self, program, scope,
                 restore_counter: bool = True) -> Tuple[int, str]:
        if self._ring:
            from ..core.executor import assign_state
            snap = self._ring[-1]
            for name, val in snap.state.items():
                assign_state(scope, name, val)
            if restore_counter:
                try:
                    program._rng_run_counter = snap.counter
                except AttributeError:
                    pass
            return snap.step, "ring"
        if self.checkpointer is not None:
            step = self._checkpoint_with_retry(self.checkpointer.restore)
            if step >= 0:
                return step, "checkpoint"
        raise RuntimeError(
            "nonfinite step but nothing to restore: snapshot ring is empty "
            "and no (complete) checkpoint is available")

    def _checkpoint_with_retry(self, fn, *args):
        """Checkpoint save/restore with the same transient-retry policy as
        steps (covers injected checkpoint_write faults and flaky stores)."""
        attempt = 0
        while True:
            try:
                return fn(*args)
            except Exception as e:
                if not is_transient(e) or attempt >= self.max_retries:
                    raise
                attempt += 1
                self._backoff(attempt, transient_site(e), e)

    def _emergency_exit(self):
        """Preemption flag is set: emergency-save at this step boundary,
        journal, close, and raise Preempted (resumable exit).  A pending
        ASYNC write is flushed synchronously first -- the process is about
        to die, so the background writer must land (or its failure must be
        known) before the emergency save decides what is still missing."""
        saved = None
        last = self.step - 1
        if self.checkpointer is not None and last >= 0:
            flush = getattr(self.checkpointer, "wait", None)
            if flush is not None:
                try:
                    self._checkpoint_with_retry(flush)
                except Exception as e:  # noqa: BLE001 -- emergency path
                    # a failed pending write must not abort the emergency
                    # save; the sync save below rewrites the state
                    _journal.emit({"event": "ckpt_save_error",
                                   "step": self.step, "where": "preempt",
                                   "error": f"{type(e).__name__}: {e}"})
            if getattr(self.checkpointer, "_last_save_step", None) != last:
                # always synchronous: an async enqueue here would race
                # process teardown
                self._checkpoint_with_retry(
                    lambda: self.checkpointer.save(last, async_=False))
            saved = last
            _OBS.counter("preemption_saves_total",
                         "emergency checkpoints written at preemption"
                         ).inc()
        _journal.emit({"event": "preempt", "step": self.step,
                       "saved_step": saved, "reason": _preempt_reason})
        _blackbox.maybe_write("preemption",
                              extra={"step": self.step, "saved_step": saved,
                                     "reason": _preempt_reason})
        self.close()
        if saved is not None:
            msg = (f"preempted ({_preempt_reason}): emergency checkpoint "
                   f"at step {saved}; resume with Checkpointer.restore()")
        else:
            msg = (f"preempted ({_preempt_reason}); no checkpointer "
                   f"attached, state was NOT saved")
        raise Preempted(msg, step=self.step, saved_step=saved)
