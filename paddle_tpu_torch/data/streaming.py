"""Fault-tolerant streaming ingestion: unbounded sources feeding the
executor's dataset loop through a bounded backpressure buffer (the port's
copy of ``paddle_tpu/data/streaming.py``).

The reference Fluid's ``QueueDataset``/DataFeed pipeline exists because
production data feeds are flaky: files lag publishers, sockets drop,
upstream jobs emit garbage.  :class:`StreamingDataset` is a
``DatasetBase`` whose ``_iter_batches`` plugs straight into
``Executor.train_from_dataset`` / ``StepGuardian.train_from_dataset``
(the prefetch worker and ``fuse_steps`` apply unchanged), with:

- **pluggable sources** (:class:`FileTailSource`, :class:`SocketSource`,
  :class:`GeneratorSource`): each runs a reader thread pushing raw
  records into one bounded buffer (``buffer_size``); a full buffer blocks
  the reader (backpressure), an empty one stalls the consumer;
- **source retry**: transient failures (``OSError`` / connection loss /
  injected ``exc@read`` faults) reconnect under the shared
  ``resilience.recovery.backoff_delay`` bounded-exponential policy,
  journaled as ``source_retry``; an exhausted budget raises a typed
  :class:`SourceLost` through the batch iterator -- never a hang
  (``idle_timeout`` bounds a silently stalled source the same way);
- **poison-record quarantine**: the shared ``DatasetBase`` bad-sample
  policy (``set_bad_sample_policy``) dead-letters malformed records with
  source attribution and escalates to a typed
  :class:`~paddle_tpu_torch.dataset_factory.PoisonFeed` past the configured
  poison-rate ceiling;
- **exact mid-stream resume**: every yielded batch commits a per-source
  watermark (position AFTER the batch's last record, read-ahead
  excluded); :meth:`StreamingDataset.watermark` rides in the
  checkpointer's ``trainstate.json`` (``StepGuardian.train_from_dataset``
  wires it), and :meth:`StreamingDataset.seek` repositions the sources so
  a preempt -> emergency-save -> restore cycle replays and drops nothing;
- **"epochs" over an unbounded stream**: :meth:`set_epoch_bound` ends
  ``_iter_batches`` after N batches and/or T seconds of wall time, so the
  standard epoch-shaped training loop works on a stream with no end;
- **freshness/depth gauges**: ``sample_age_seconds`` (ingest-to-dispatch
  age of each batch's oldest record) and ``stream_buffer_depth`` in the
  observability registry.

Record order across sources. By default the sources' reader threads race
into one buffer, as in the JAX package: records reach the batches in
arrival order, which differs from run to run when there are several
sources (ROADMAP fault 3.15), so a resume drops and replays nothing but
does not rebuild the same batches. ``ordered=True`` merges the sources in a
fixed rotation instead -- one record from each live source in turn, a
finished source leaving the rotation -- and the watermark carries whose
turn is next (``next_source``): two runs over the same data, or a run and
its resume, then build the same batches bit for bit. Its price: a source
that lags stalls the others until it delivers (``idle_timeout`` bounds
that as it bounds a silent stream).

All waiting runs through the injectable :class:`~paddle_tpu.utils.clock`
seam, so the chaos selftest drives retry/backoff/tail-poll hermetically
(FakeClock, zero real sleeps).  Fault sites ``read``/``parse``
(``resilience/faults.py``) hook the reader and the parser; disarmed they
cost one module-attribute read per record.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..dataset_factory import DatasetBase, PoisonFeed  # noqa: F401 (re-export)
from ..observability import journal as _journal
from ..observability.metrics import REGISTRY as _OBS
from ..resilience import faults as _faults
from ..resilience.recovery import backoff_delay, is_transient
from ..utils.clock import Clock, FakeClock, MonotonicClock  # noqa: F401

__all__ = [
    "StreamError", "SourceLost", "PoisonFeed", "StreamSource",
    "FileTailSource", "SocketSource", "GeneratorSource",
    "StreamingDataset",
]

STATE_FORMAT_VERSION = 1


class StreamError(RuntimeError):
    """Base class for typed streaming-ingestion failures."""


class SourceLost(StreamError):
    """A source exhausted its reconnect budget (or stayed silent past
    ``idle_timeout``): the stream cannot make progress, so the epoch ends
    with this typed error instead of a hung prefetch."""

    def __init__(self, msg: str, source: str = "?", attempts: int = 0):
        super().__init__(msg)
        self.source = source
        self.attempts = attempts


# ---------------------------------------------------------------- sources --

class StreamSource:
    """One pluggable record source.  Contract:

    - :meth:`open` (re)establishes the connection -- called initially and
      after every transient failure; it must honor the position set by
      the latest :meth:`seek` (resume / reconnect-without-replay);
    - :meth:`records` yields ``(text, pos)`` where ``pos`` is the
      source's position AFTER that record (byte offset for files, record
      ordinal otherwise) -- the watermark unit;
    - transient trouble raises ``OSError`` (or anything
      ``recovery.is_transient`` accepts); a clean return from
      :meth:`records` means the source is exhausted (finite source / tail
      mode ended).

    ``name`` attributes quarantined records, retry journals and fault
    targeting (``var=<name>`` at the ``read`` site)."""

    name = "source"

    def open(self, clock: Clock):  # pragma: no cover - interface
        raise NotImplementedError

    def records(self):  # pragma: no cover - interface
        raise NotImplementedError

    def seek(self, pos):
        raise NotImplementedError

    def tell(self):
        """The position a reconnect should resume from (the reader seeds
        its delivered-position bookkeeping with this before the first
        record, so a fault hitting record 0 cannot skip it)."""
        raise NotImplementedError

    def close(self):
        pass


class FileTailSource(StreamSource):
    """Lines from a file, tracking byte offsets; ``follow=True`` keeps
    polling for appended data (``tail -f``), ``follow=False`` ends at
    EOF.  A missing/vanished file raises ``OSError`` -- the retry path's
    job.  ``seek`` takes a byte offset (exact resume)."""

    def __init__(self, path: str, follow: bool = False,
                 poll_interval: float = 0.05, name: Optional[str] = None):
        self.path = path
        self.follow = bool(follow)
        self.poll_interval = float(poll_interval)
        self.name = name or str(path)
        self._pos = 0
        self._f = None
        self._clock: Optional[Clock] = None
        self.stop = threading.Event()   # ends follow-mode tailing

    def open(self, clock: Clock):
        self.close()
        self.stop.clear()   # a prior epoch's wind-down must not end THIS
        #                     epoch's tailing at its first EOF
        self._clock = clock
        self._f = open(self.path, "r")
        self._f.seek(self._pos)

    def seek(self, pos):
        self._pos = int(pos)
        if self._f is not None:
            self._f.seek(self._pos)

    def tell(self):
        return self._pos

    def records(self):
        # the handle is captured LOCALLY: a stale reader generator from a
        # prior epoch that wakes after the source was reopened must keep
        # touching its own (closed) handle -- reading self._f would let
        # it steal records from the new epoch's handle
        f = self._f
        while True:
            line = f.readline()
            if line.endswith("\n"):
                self._pos = f.tell()
                if line.strip():
                    yield line, self._pos
                continue
            # EOF (or a torn final line still being appended).  An
            # unterminated tail is NEVER consumed, in either mode:
            # records are newline-delimited, and taking the fragment
            # would commit a watermark past torn bytes -- a resume on a
            # since-grown file would then parse the appended remainder
            # as a fresh (silently wrong) record.  The bytes stay ahead
            # of the watermark and are re-read complete by the next
            # poll, epoch, or resumed run.
            if not self.follow:
                if line.strip():
                    _journal.emit({"event": "stream_torn_tail",
                                   "source": self.name, "pos": self._pos,
                                   "detail": "unterminated final line "
                                             "left unconsumed (no "
                                             "trailing newline)"})
                return
            if self.stop.is_set():
                return
            f.seek(self._pos)   # re-read the torn tail next poll
            self._clock.sleep(self.poll_interval)

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


class GeneratorSource(StreamSource):
    """Records from a factory returning an iterable of lines.  The
    factory is re-invoked on every (re)open; ``seek``/reconnect skip the
    already-consumed prefix, so a deterministic factory gives exact
    resume.  ``pos`` is the record ordinal."""

    def __init__(self, factory, name: str = "generator"):
        self.factory = factory
        self.name = name
        self._pos = 0
        self._it = None

    def open(self, clock: Clock):
        import itertools
        # C-level skip of the consumed prefix; note a reconnect still
        # re-PRODUCES the prefix, so factories with per-record cost
        # (files, RPCs) belong behind a seekable source instead
        self._it = itertools.islice(iter(self.factory()), self._pos, None)

    def seek(self, pos):
        self._pos = int(pos)
        self._it = None   # next open() re-skips

    def tell(self):
        return self._pos

    def records(self):
        for line in self._it:
            self._pos += 1
            yield line, self._pos


class SocketSource(StreamSource):
    """Newline-delimited records from a TCP endpoint (the live
    click-stream shape).  A dropped connection raises ``OSError`` and the
    retry path reconnects; the server is expected to resume the stream
    (positions are record ordinals -- a socket cannot replay, so
    :meth:`seek` just restores the counter and journals the fact)."""

    def __init__(self, host: str, port: int, name: Optional[str] = None,
                 connect_timeout: float = 5.0):
        self.host = host
        self.port = int(port)
        self.name = name or f"{host}:{port}"
        self.connect_timeout = float(connect_timeout)
        self._pos = 0
        self._sock = None
        self._rfile = None

    def open(self, clock: Clock):
        import socket
        self.close()
        self._sock = socket.create_connection(
            (self.host, self.port), timeout=self.connect_timeout)
        # the connect timeout must not linger as a READ timeout: a
        # healthy-but-quiet stream would hit socket.timeout on every gap
        # and churn reconnects (dropping unreplayable records) until the
        # retry budget died -- quiet-stream bounding belongs to the
        # dataset's idle_timeout, not the transport
        self._sock.settimeout(None)
        self._rfile = self._sock.makefile("r")

    def tell(self):
        return self._pos

    def seek(self, pos):
        if int(pos) != self._pos:
            _journal.emit({"event": "stream_seek_gap", "source": self.name,
                           "detail": "socket sources cannot replay; "
                                     "resuming at the live position",
                           "have": self._pos, "want": int(pos)})
        self._pos = int(pos)

    def records(self):
        for line in self._rfile:
            if line.strip():
                self._pos += 1
                yield line, self._pos
        # EOF on a socket IS the connection dropping (a closed peer reads
        # as end-of-file, not an error): surface it transient so the
        # retry path reconnects; a stream that is genuinely gone exhausts
        # the budget into SourceLost, and epoch bounds / idle_timeout end
        # consumption of a healthy-but-quiet stream
        raise ConnectionResetError(
            f"stream connection to {self.host}:{self.port} closed by peer "
            f"after {self._pos} record(s)")

    def close(self):
        for h in (self._rfile, self._sock):
            if h is not None:
                try:
                    h.close()
                except OSError:
                    pass
        self._rfile = self._sock = None


# ----------------------------------------------------------- the dataset --

_DONE = object()


class _StreamIter:
    """The object ``_iter_batches`` returns: a plain iterator plus the
    ``abort()``/``close()`` hooks the executor's prefetch loop uses to
    stop reader threads when an epoch is abandoned mid-flight."""

    def __init__(self, gen, stop: threading.Event):
        self._gen = gen
        self._stop = stop

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)

    def abort(self):
        """Signal the reader threads + consumer loop to wind down (safe
        from any thread; the generator itself keeps running until its
        next buffer poll notices)."""
        self._stop.set()

    def close(self):
        self._stop.set()
        self._gen.close()


class StreamingDataset(DatasetBase):
    """Unbounded streaming Dataset over pluggable sources.  Usage::

        ds = StreamingDataset(buffer_size=256)
        ds.add_source(FileTailSource("clicks.txt", follow=True))
        ds.set_use_var([x, label]); ds.set_batch_size(64)
        ds.set_bad_sample_policy("quarantine",
                                 dead_letter_path="dead.jsonl",
                                 max_poison_rate=0.5)
        ds.set_epoch_bound(steps=1000)        # one "epoch" = 1000 batches
        exe.train_from_dataset(main, ds, fetch_list=[loss])

    ``set_filelist([...])`` is honored as a convenience: each file becomes
    a non-follow :class:`FileTailSource` (QueueDataset drop-in).  See the
    module docstring for the full robustness contract."""

    def __init__(self, buffer_size: int = 256, max_retries: int = 5,
                 retry_backoff: float = 0.05, retry_backoff_max: float = 2.0,
                 idle_timeout: Optional[float] = None,
                 clock: Optional[Clock] = None,
                 retry_seed: Optional[int] = None, ordered: bool = False):
        super().__init__()
        if buffer_size < 1:
            raise ValueError("buffer_size must be >= 1")
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        self.sources: List[StreamSource] = []
        self.buffer_size = int(buffer_size)
        self.max_retries = int(max_retries)
        self.retry_backoff = float(retry_backoff)
        self.retry_backoff_max = float(retry_backoff_max)
        self.idle_timeout = idle_timeout
        self.clock: Clock = clock or MonotonicClock()
        self._retry_seed = retry_seed
        self.ordered = bool(ordered)
        # ordered merge: the source whose turn is next (None: the first)
        self._next_source: Optional[str] = None
        self._epoch_steps: Optional[int] = None
        self._epoch_seconds: Optional[float] = None
        # committed per-source watermarks + the per-batch snapshot ring
        self._positions: Dict[str, object] = {}
        self._batches_yielded = 0
        self._records_consumed = 0
        self._marks: "Dict[int, dict]" = {0: self._state_doc()}
        self._marks_cap = 4096
        # epoch generation + lock: a stale reader thread surviving a
        # prior epoch's bounded join must never close() (or otherwise
        # tear down) the source under the CURRENT epoch's reader
        self._epoch_gen = 0
        self._src_lock = threading.Lock()

    # -- configuration ------------------------------------------------------

    def add_source(self, source: StreamSource) -> StreamSource:
        if any(s.name == source.name for s in self.sources):
            raise ValueError(f"duplicate source name {source.name!r}")
        self.sources.append(source)
        return source

    def set_sources(self, sources: Sequence[StreamSource]):
        names = [s.name for s in sources]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate source names in {names}")
        self.sources = list(sources)

    def set_epoch_bound(self, steps: Optional[int] = None,
                        seconds: Optional[float] = None):
        """Bound one ``_iter_batches`` pass over the unbounded stream:
        stop after ``steps`` batches and/or ``seconds`` of wall time
        (whichever first).  Unset = run until every source is exhausted
        (follow-mode sources never are -- set a bound)."""
        self._epoch_steps = None if steps is None else int(steps)
        self._epoch_seconds = None if seconds is None else float(seconds)

    def local_shuffle(self):
        raise ValueError("StreamingDataset streams; use InMemoryDataset "
                         "for shuffling")

    def global_shuffle(self, fleet=None):
        raise ValueError("StreamingDataset streams; use InMemoryDataset")

    # -- stream position (exact mid-stream resume) --------------------------

    def _state_doc(self) -> dict:
        doc = {"format_version": STATE_FORMAT_VERSION,
               "sources": dict(self._positions),
               "records": self._records_consumed,
               "dead_letters": self._quarantined}
        if self.ordered:
            doc["next_source"] = self._next_source
        return doc

    def stream_state(self) -> dict:
        """The committed stream position: per-source watermark (position
        after the last record consumed into a YIELDED batch -- read-ahead
        excluded), total records consumed, dead-letter count.  This is
        what rides in ``trainstate.json``."""
        return self._state_doc()

    def watermark(self, batches_consumed: int) -> Optional[dict]:
        """The stream position after ``batches_consumed`` yielded batches
        (0 = the seek/start position).  Snapshots are kept for the last
        ``_marks_cap`` batches -- far past any prefetch read-ahead."""
        return self._marks.get(int(batches_consumed))

    def seek(self, state: Optional[dict]):
        """Reposition every source at a :meth:`stream_state` /
        :meth:`watermark` document (exact resume).  Unknown sources in
        the doc are ignored with a journal note; sources not in the doc
        start from their current position."""
        if not state:
            return
        self._materialize_filelist()   # a set_filelist() dataset must
        #                                have its sources BEFORE the
        #                                name filter below, or every
        #                                saved watermark would be dropped
        #                                and the resume would replay
        positions = dict(state.get("sources") or {})
        by_name = {s.name: s for s in self.sources}
        for name, pos in positions.items():
            src = by_name.get(name)
            if src is None:
                _journal.emit({"event": "stream_seek_gap", "source": name,
                               "detail": "saved source not attached; "
                                         "its position was dropped"})
                continue
            src.seek(pos)
        self._positions = {n: p for n, p in positions.items()
                           if n in by_name}
        self._records_consumed = int(state.get("records") or 0)
        self._quarantined = int(state.get("dead_letters") or 0)
        self._next_source = state.get("next_source")
        # the poison-rate ceiling runs on a per-epoch window (reset at
        # every _stream_batches pass), so the restored cumulative
        # dead-letter count above never skews a resumed run's ratio
        self._batches_yielded = 0
        self._marks = {0: self._state_doc()}
        _journal.emit({"event": "stream_seek",
                       "sources": dict(self._positions),
                       "records": self._records_consumed,
                       "dead_letters": self._quarantined})

    # -- reader threads -----------------------------------------------------

    def _close_source(self, src: StreamSource, gen: int):
        """Close ``src`` only if the closing reader still belongs to the
        current epoch (see ``_epoch_gen``): a new epoch's ``open()``
        already replaced the handles, so a stale closer must not touch
        them -- and the old handles were closed by that reopen."""
        with self._src_lock:
            if gen == self._epoch_gen:
                src.close()

    def _read_source(self, src: StreamSource, buf: "queue.Queue",
                     stop: threading.Event, gen: int, start_pos):
        """One source's reader loop: open -> stream records into the
        bounded buffer (backpressure = blocking put) -> reconnect with
        bounded exponential backoff on transient failure.  Terminal
        outcomes are pushed INTO the buffer (``SourceLost`` or the done
        sentinel) so the consumer never hangs on a dead reader."""
        import random as _random
        rng = _random.Random(self._retry_seed)
        attempt = 0
        rec_idx = 0
        # source position after the last DELIVERED record (seeded with
        # the epoch's committed start position, passed in by
        # _stream_batches): a reconnect seeks back here, so a record a
        # fault hit mid-flight -- including record 0, which the source's
        # internal cursor has already moved past -- is re-read and
        # delivered exactly once
        delivered_pos = start_pos

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    buf.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        while not stop.is_set():
            try:
                src.seek(delivered_pos)
                src.open(self.clock)
                for text, pos in src.records():
                    if _faults._active:
                        _faults.fire("read", step=rec_idx,
                                     tags=[src.name])
                        text = _faults.corrupt_record(
                            text, "read", step=rec_idx, tags=[src.name])
                    rec_idx += 1
                    attempt = 0
                    if not _put((src.name, text, pos,
                                 self.clock.now())):
                        self._close_source(src, gen)
                        return
                    delivered_pos = pos
                    if stop.is_set():
                        self._close_source(src, gen)
                        return
                self._close_source(src, gen)
                _put((src.name, _DONE, None, None))
                return
            except Exception as e:  # noqa: BLE001 -- classified below
                self._close_source(src, gen)
                if stop.is_set():
                    # the epoch already ended: the error is teardown
                    # fallout (our own close, the peer noticing), not a
                    # source failure -- no retry, no journal noise
                    return
                if not is_transient(e):
                    _put((src.name, e, None, None))
                    return
                attempt += 1
                if attempt > self.max_retries:
                    _OBS.counter("source_lost_total",
                                 "sources that exhausted their reconnect "
                                 "budget", source=src.name).inc()
                    _journal.emit({"event": "source_lost",
                                   "source": src.name,
                                   "attempts": attempt - 1,
                                   "error": str(e)[:200]})
                    _put((src.name, SourceLost(
                        f"source {src.name!r} lost after "
                        f"{attempt - 1} reconnect attempts: "
                        f"{type(e).__name__}: {e}", source=src.name,
                        attempts=attempt - 1), None, None))
                    return
                delay = backoff_delay(attempt, self.retry_backoff,
                                      self.retry_backoff_max, rng)
                _OBS.counter("source_retries_total",
                             "streaming source reconnect attempts",
                             source=src.name).inc()
                _journal.emit({"event": "source_retry",
                               "source": src.name, "attempt": attempt,
                               "backoff_ms": round(delay * 1e3, 1),
                               "error": str(e)[:200]})
                self.clock.sleep(delay)
        self._close_source(src, gen)

    # -- iteration ----------------------------------------------------------

    def _materialize_filelist(self):
        """QueueDataset drop-in: each ``set_filelist`` entry becomes a
        finite tail source (idempotent; explicit sources win)."""
        if not self.sources and self.filelist:
            self.set_sources([FileTailSource(p) for p in self.filelist])

    def _iter_batches(self):
        if self._samples is not None:    # pre-loaded (tests): eager path
            return DatasetBase._iter_batches(self)
        self._materialize_filelist()
        if not self.sources:
            raise ValueError("StreamingDataset needs at least one source "
                             "(add_source / set_sources / set_filelist)")
        if not self.use_vars:
            raise ValueError("call set_use_var() first (feed names come "
                             "from the use_var list)")
        stop = threading.Event()
        return _StreamIter(self._stream_batches(stop), stop)

    def _stream_batches(self, stop: threading.Event):
        # each epoch restarts from the COMMITTED watermark: rows a prior
        # epoch read ahead but never yielded are re-read, not lost.  A
        # source with no committed batch yet gets its START position
        # recorded first -- otherwise a prior epoch that ended before its
        # first flush (PoisonFeed, abort) would leave the source's
        # internal cursor at wherever the reader ran ahead to
        with self._src_lock:
            self._epoch_gen += 1
            gen = self._epoch_gen
        for src in self.sources:
            self._positions.setdefault(src.name, src.tell())
            src.seek(self._positions[src.name])
        self._batches_yielded = 0
        self._reset_poison_window()
        self._marks = {0: self._state_doc()}
        buf: "queue.Queue" = queue.Queue(maxsize=self.buffer_size)
        # ordered: a buffer per source, read in rotation
        bufs = {src.name: (queue.Queue(maxsize=self.buffer_size) if self.ordered
                           else buf) for src in self.sources}
        live = [src.name for src in self.sources]
        turn = live.index(self._next_source) if self._next_source in live else 0
        threads = []
        for src in self.sources:
            t = threading.Thread(target=self._read_source,
                                 args=(src, bufs[src.name], stop, gen,
                                       self._positions[src.name]),
                                 daemon=True,
                                 name=f"stream-read-{src.name}")
            t.start()
            threads.append(t)
        names = [v.name for v in self.use_vars]
        bs = self.batch_size
        depth_gauge = _OBS.gauge(
            "stream_buffer_depth",
            "records queued in the streaming backpressure buffer")
        age_hist = _OBS.histogram(
            "sample_age_seconds",
            "ingest-to-dispatch age of each batch's oldest record")
        rec_counter = _OBS.counter(
            "stream_records_total", "records ingested from stream sources")
        rows: list = []
        pending_pos: Dict[str, object] = {}   # per-source pos since flush
        pending_records = 0                   # consumed records since flush
        pending_next = self._next_source      # ordered: whose turn, at flush
        oldest_ts: Optional[float] = None
        active = len(self.sources)
        t0 = self.clock.now()
        last_record_t = t0
        n_out = 0
        rec_seen = 0   # consumer-side record ordinal (parse fault site)

        def _bounded() -> bool:
            if self._epoch_steps is not None and \
                    n_out >= self._epoch_steps:
                return True
            if self._epoch_seconds is not None and \
                    self.clock.now() - t0 >= self._epoch_seconds:
                return True
            return False

        def _flush():
            """Yielded batch: commit the records consumed since the last
            flush (incl. quarantined lines -- a resume must not replay
            them into the dead-letter file twice), stamp gauges."""
            nonlocal oldest_ts, pending_records
            cols = list(zip(*rows))
            feed = {nm: np.stack([np.asarray(x) for x in c])
                    for nm, c in zip(names, cols)}
            self._positions.update(pending_pos)
            self._next_source = pending_next
            self._records_consumed += pending_records
            self._batches_yielded += 1
            self._marks[self._batches_yielded] = self._state_doc()
            self._marks.pop(self._batches_yielded - self._marks_cap, None)
            if oldest_ts is not None:
                age_hist.observe(max(0.0, self.clock.now() - oldest_ts))
            depth_gauge.set(sum(q.qsize() for q in set(bufs.values())))
            rows.clear()
            pending_pos.clear()
            pending_records = 0
            oldest_ts = None
            return feed

        try:
            while not stop.is_set() and not _bounded():
                try:
                    item = (bufs[live[turn]] if self.ordered else buf).get(timeout=0.05)
                except queue.Empty:
                    if active <= 0:
                        break
                    if self.idle_timeout is not None and \
                            self.clock.now() - last_record_t >= \
                            self.idle_timeout:
                        raise SourceLost(
                            f"stream produced no record for "
                            f"{self.idle_timeout}s (idle_timeout); "
                            f"{active} source(s) still attached but "
                            f"silent", attempts=0)
                    continue
                src_name, text, pos, ts = item
                if text is _DONE:
                    active -= 1
                    if self.ordered:
                        live.remove(src_name)
                        if not live:
                            break
                        turn %= len(live)
                        continue
                    if active <= 0 and buf.empty():
                        break
                    continue
                if isinstance(text, BaseException):
                    raise text
                if self.ordered:
                    turn = (turn + 1) % len(live)
                    pending_next = live[turn]
                last_record_t = self.clock.now()
                rec_counter.inc()
                where = f"{src_name}:{pos}"
                inj_err = None
                if _faults._active:
                    # the `parse` fault site: exc fails THIS record's
                    # parse (routed through the bad-sample policy like
                    # any malformed line), corrupt garbles its text,
                    # hang stalls the parser
                    try:
                        _faults.fire("parse", step=rec_seen,
                                     tags=[src_name])
                    except _faults.TransientFault as e:
                        inj_err = e
                    text = _faults.corrupt_record(
                        text, "parse", step=rec_seen, tags=[src_name])
                rec_seen += 1
                if inj_err is not None:
                    if self._bad_policy == "raise":
                        raise ValueError(
                            f"injected parse fault at {where}: "
                            f"{inj_err}") from inj_err
                    self._parse_total += 1
                    self._quarantine(text, where, inj_err)
                    sample = None
                else:
                    sample = self._parse_guarded(text, where=where)
                pending_pos[src_name] = pos
                pending_records += 1
                if sample is None:
                    continue   # quarantined; watermark advances at flush
                if oldest_ts is None:
                    oldest_ts = ts
                rows.append(sample)
                if len(rows) == bs:
                    yield _flush()
                    n_out += 1
            if rows and not self.drop_last and not stop.is_set() \
                    and not _bounded():
                yield _flush()
                n_out += 1
            if n_out == 0 and not stop.is_set():
                import warnings
                warnings.warn("StreamingDataset yielded no batches "
                              "(empty/bounded-out stream)", UserWarning)
            _journal.emit({"event": "stream_epoch", "batches": n_out,
                           "records": self._records_consumed,
                           "dead_letters": self._quarantined,
                           "sources": dict(self._positions)})
        finally:
            stop.set()
            for src in self.sources:
                s = getattr(src, "stop", None)
                if s is not None:
                    s.set()
            for t in threads:
                # sized to outlive a reader parked in retry backoff
                # (backoff_delay caps at 1.5x retry_backoff_max); a
                # reader stuck in a blocking connect stays a daemon and
                # is fenced off by the _close_source generation guard
                t.join(timeout=max(1.0, 2 * self.retry_backoff_max))
