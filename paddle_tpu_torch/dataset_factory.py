"""Datasets over MultiSlot text files: ``InMemoryDataset``, ``QueueDataset``
and ``DatasetFactory`` (the port's copy of ``paddle_tpu/dataset_factory.py``;
``create_dataset("StreamingDataset")`` returns ``data/streaming.py``'s).

One sample per line, slots separated by ``;``, values by spaces, in the
order of ``set_use_var`` (``incubate/data_generator.py`` writes this
format); ``set_parse_fn(line) -> tuple`` replaces the parser. A file is
parsed by the native C++ parser (``native/``) into one matrix per slot when
it is rectangular and every integer slot is integral with |v| < 2^24 (so
that its float32 parse is exact), else line by line in Python. Shuffles are
index permutations; ``global_shuffle`` draws the same permutation in every
process and keeps this process's stripe of rows. ``Executor.train_from_dataset``
takes the batches of ``_iter_batches()`` through its prefetch thread.

Policies: a missing file raises, or with ``set_missing_file_policy("skip")``
is skipped, journaled (``source_skipped``) and counted
(``sources_skipped_total``); a malformed line raises, or with
``set_bad_sample_policy("quarantine")`` goes to a dead-letter JSONL file,
the journal (``sample_quarantined``) and ``samples_quarantined_total{reason}``,
until the quarantined share passes ``max_poison_rate`` (``PoisonFeed``).
Everything here is host work: numpy arrays out, no device.
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Callable, List, Optional

import numpy as np

from . import native
from .observability import journal
from .observability.metrics import REGISTRY
from .parallel import env as penv

BAD_SAMPLE_POLICIES = ("raise", "quarantine")
MISSING_FILE_POLICIES = ("raise", "skip")


class PoisonFeed(RuntimeError):
    """The quarantined-sample rate passed its ceiling: the feed is corrupt,
    and training on what still parses would be worse than stopping."""

    def __init__(self, msg: str, quarantined: int = 0, total: int = 0):
        super().__init__(msg)
        self.quarantined = quarantined
        self.total = total


class DeadLetterWriter:
    """Append-only JSONL sink for quarantined lines: the source position
    (``where``, ``file:line``), the reason, the error and the text
    (truncated). Opened at the first quarantine, flushed per write, and
    deduplicated by position, also across processes that reopen the file
    (its entries are read again on open)."""

    MAX_TEXT = 512

    def __init__(self, path: str):
        self.path = path
        self._f = None
        self._seen = None

    def write(self, where: str, reason: str, error: str, text: str) -> bool:
        """Record one line; False (and nothing written) if this position
        was recorded already."""
        if self._f is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._seen = set()
            if os.path.exists(self.path):
                try:
                    with open(self.path) as f:
                        for ln in f:
                            if ln.strip():
                                self._seen.add(json.loads(ln).get("where"))
                except (OSError, ValueError):
                    pass   # unreadable earlier entries: record anew
            self._f = open(self.path, "a")
        if where in self._seen:
            return False
        self._seen.add(where)
        self._f.write(json.dumps(
            {"where": where, "reason": reason, "error": str(error)[:200],
             "line": str(text)[:self.MAX_TEXT]}, sort_keys=True) + "\n")
        self._f.flush()
        return True

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
            self._seen = None


class DatasetBase:
    def __init__(self):
        self.batch_size = 1
        self.use_vars = []
        self.filelist: List[str] = []
        self.thread_num = 1
        self.drop_last = False
        self.on_missing_file = "raise"
        self._parse_fn: Optional[Callable] = None
        self._samples = None     # row list of tuples, or one matrix per slot
        self._perm = None        # shuffle permutation (a view, not a copy)
        self._stripe = None      # (rank, world) set by global_shuffle
        self._epoch_seed = 0
        self._bad_policy = "raise"
        self._dead_letter: Optional[DeadLetterWriter] = None
        self._max_poison_rate: Optional[float] = None
        self._poison_floor = 20          # samples parsed before the ceiling arms
        # the ceiling's window, reset per load or epoch, against the
        # cumulative count of dead letters
        self._parse_total = 0
        self._rate_quarantined = 0
        self._quarantined = 0

    # -- configuration -------------------------------------------------------------------
    def set_batch_size(self, batch_size):
        self.batch_size = int(batch_size)

    def set_thread(self, thread_num):
        """The native parser's threads and the prefetch queue's depth."""
        self.thread_num = int(thread_num)

    def set_use_var(self, var_list):
        self.use_vars = list(var_list)

    def set_filelist(self, filelist):
        self.filelist = list(filelist)

    def set_pipe_command(self, pipe_command):
        warnings.warn("Dataset: pipe_command (a subprocess parser) is replaced by "
                      "set_parse_fn(line)->tuple", UserWarning)

    def set_hdfs_config(self, fs_name, fs_ugi):
        raise NotImplementedError("HDFS IO: mount the data locally")

    def set_parse_fn(self, fn):
        """fn(line: str) -> one array or scalar per use_var."""
        self._parse_fn = fn

    def set_missing_file_policy(self, policy: str):
        """``"raise"`` (default) or ``"skip"``: a missing file is skipped,
        journaled as ``source_skipped`` and counted in
        ``sources_skipped_total``."""
        if policy not in MISSING_FILE_POLICIES:
            raise ValueError(f"on_missing_file must be one of "
                             f"{MISSING_FILE_POLICIES}, got {policy!r}")
        self.on_missing_file = policy

    def set_bad_sample_policy(self, policy: str = "quarantine",
                              dead_letter_path: Optional[str] = None,
                              max_poison_rate: Optional[float] = None,
                              poison_floor: int = 20):
        """``"raise"`` (default): a malformed line raises ValueError with its
        position. ``"quarantine"``: the line goes to the dead-letter file
        (``dead_letter_path``, default ``paddle_tpu_dead_letters.jsonl``),
        is counted in ``samples_quarantined_total{reason}`` and skipped,
        unless the quarantined share passes ``max_poison_rate`` once
        ``poison_floor`` samples were parsed: then ``PoisonFeed``."""
        if policy not in BAD_SAMPLE_POLICIES:
            raise ValueError(f"on_bad_sample must be one of "
                             f"{BAD_SAMPLE_POLICIES}, got {policy!r}")
        self._bad_policy = policy
        if self._dead_letter is not None:
            self._dead_letter.close()
        if policy == "quarantine":
            self._dead_letter = DeadLetterWriter(
                dead_letter_path or "paddle_tpu_dead_letters.jsonl")
            self._max_poison_rate = None if max_poison_rate is None else float(max_poison_rate)
            self._poison_floor = int(poison_floor)
        else:
            self._dead_letter = None
            self._max_poison_rate = None

    # -- parsing ---------------------------------------------------------------------------
    def _parse_line(self, line, where: Optional[str] = None):
        if self._parse_fn is not None:
            return tuple(self._parse_fn(line))
        slots = line.strip().split(";")
        at = f" at {where}" if where else ""
        if len(slots) != len(self.use_vars):
            raise ValueError(
                f"line{at} has {len(slots)} slots but set_use_var lists "
                f"{len(self.use_vars)} vars (separate slots with ';' or use "
                f"set_parse_fn)")
        out = []
        for s, v in zip(slots, self.use_vars):
            dt = v.dtype if v.dtype != "bfloat16" else "float32"
            vals = s.split()
            try:
                out.append(np.asarray(vals, dtype=np.dtype(dt)) if vals
                           else np.zeros((0,), dt))
            except ValueError as e:
                raise ValueError(f"slot for var {v.name!r}{at} does not parse as "
                                 f"{dt}: {e}") from e
        return tuple(out)

    def _parse_guarded(self, line, where: Optional[str] = None):
        """One line under the bad-sample policy: the parsed tuple, or None
        when it was quarantined."""
        if self._bad_policy == "raise":
            return self._parse_line(line, where=where)
        self._parse_total += 1
        try:
            return self._parse_line(line, where=where)
        except PoisonFeed:
            raise
        except Exception as e:  # noqa: BLE001 -- every parse failure is quarantined
            self._quarantine(line, where, e)
            return None

    def _quarantine(self, line, where, err):
        """Dead-letter one line (counter, journal, JSONL record), then hold
        the poison-rate ceiling."""
        reason = "slot_count" if "slots but set_use_var" in str(err) else "parse_error"
        self._quarantined += 1
        self._rate_quarantined += 1
        # the counter and the journal see each position once: a re-parse in a
        # later epoch must not inflate them
        if self._dead_letter.write(where or "?", reason, err, line):
            REGISTRY.counter("samples_quarantined_total",
                             "malformed samples dead-lettered by the quarantine policy, "
                             "by reason", reason=reason).inc()
            journal.emit({"event": "sample_quarantined", "where": where, "reason": reason,
                          "error": str(err)[:120], "dead_letter": self._dead_letter.path})
        if (self._max_poison_rate is not None
                and self._parse_total >= self._poison_floor
                and self._rate_quarantined / self._parse_total > self._max_poison_rate):
            raise PoisonFeed(
                f"poison-record rate {self._rate_quarantined}/{self._parse_total} = "
                f"{self._rate_quarantined / self._parse_total:.1%} exceeds the "
                f"{self._max_poison_rate:.1%} ceiling (last offender {where}); the feed "
                f"looks corrupt -- refusing to keep training on it (dead letters: "
                f"{self._dead_letter.path})",
                quarantined=self._rate_quarantined, total=self._parse_total)

    def _reset_poison_window(self):
        self._parse_total = 0
        self._rate_quarantined = 0

    def _missing_file(self, path) -> bool:
        """True: skip ``path`` (journaled); under "raise", FileNotFoundError."""
        if self.on_missing_file != "skip":
            raise FileNotFoundError(f"dataset file {path!r} not found")
        REGISTRY.counter("sources_skipped_total",
                         "dataset files skipped by on_missing_file=skip").inc()
        journal.emit({"event": "source_skipped", "file": str(path)})
        return True

    def _read_python(self, path):
        rows = []
        with open(path) as f:
            for ln, line in enumerate(f, 1):
                if line.strip():
                    s = self._parse_guarded(line, where=f"{path}:{ln}")
                    if s is not None:
                        rows.append(s)
        return rows

    def _read_files(self):
        """One matrix per slot when every file parsed natively, else a row
        list of tuples (a file that needs the Python parser demotes the
        columns read before it)."""
        self._reset_poison_window()
        col_parts: Optional[List[List[np.ndarray]]] = None
        samples = []
        for path in self.filelist:
            if not os.path.exists(path) and self._missing_file(path):
                continue
            cols = self._read_native(path)
            if cols is not None and not samples:
                if col_parts is None:
                    col_parts = [[] for _ in cols]
                for parts, c in zip(col_parts, cols):
                    parts.append(c)
                continue
            if cols is not None:        # native after Python files: as rows
                samples.extend(zip(*[list(c) for c in cols]))
                continue
            if col_parts is not None:   # demote the columns read so far
                merged = [np.concatenate(p) for p in col_parts]
                samples.extend(zip(*[list(c) for c in merged]))
                col_parts = None
            samples.extend(self._read_python(path))
        if col_parts is not None and not samples:
            return [np.concatenate(p) for p in col_parts]
        return samples

    def _read_native(self, path):
        """The native parse of ``path``, typed per use_var, or None: no
        library, a custom parse_fn, a file the parser refuses (ragged,
        malformed: the Python parser handles or reports it), or an integer
        slot whose values float32 does not hold exactly (|v| >= 2^24 or not
        integral)."""
        if self._parse_fn is not None or not self.use_vars:
            return None
        try:
            parsed = native.parse_slot_file(path, len(self.use_vars), n_threads=self.thread_num)
        except ValueError:
            return None
        if parsed is None:
            return None
        typed = []
        for c, v in zip(parsed[1], self.use_vars):
            dt = v.dtype if v.dtype != "bfloat16" else "float32"
            if np.issubdtype(np.dtype(dt), np.integer):
                if (np.abs(c) >= 2 ** 24).any() or (c != np.floor(c)).any():
                    return None
                c = c.astype(np.dtype(dt))
            elif dt != "float32":
                c = c.astype(np.dtype(dt))
            typed.append(c)
        return typed

    @staticmethod
    def _is_columnar(samples):
        return (isinstance(samples, list) and bool(samples)
                and isinstance(samples[0], np.ndarray) and samples[0].ndim == 2)

    def _n_samples(self, samples):
        return samples[0].shape[0] if self._is_columnar(samples) else len(samples)

    @staticmethod
    def _stack_rows(names, rows):
        cols = list(zip(*rows))
        return {nm: np.stack([np.asarray(x) for x in c]) for nm, c in zip(names, cols)}

    # -- iteration ---------------------------------------------------------------------
    def _iter_batches(self):
        """Feed dicts (name -> numpy batch) over the loaded or freshly read
        samples, through the permutation and stripe."""
        samples = self._samples if self._samples is not None else self._read_files()
        columnar = self._is_columnar(samples)
        idx = self._perm if self._perm is not None else np.arange(self._n_samples(samples))
        if self._stripe is not None:
            r, w = self._stripe
            idx = idx[r::w]
        names = [v.name for v in self.use_vars]
        bs = self.batch_size
        n = len(idx)
        if n == 0 or (self.drop_last and n < bs):
            warnings.warn(f"Dataset yields no batches: {n} samples on this host vs "
                          f"batch_size={bs}", UserWarning)
            return
        for i in range(0, n, bs):
            take = idx[i:i + bs]
            if len(take) < bs and self.drop_last:
                return
            if columnar:
                yield {nm: c[take] for nm, c in zip(names, samples)}
            else:
                yield self._stack_rows(names, [samples[j] for j in take])


class InMemoryDataset(DatasetBase):
    """Loaded once, shuffled by permutations of row indices."""

    def load_into_memory(self):
        self._samples = self._read_files()

    def preload_into_memory(self, thread_num=None):
        self.load_into_memory()

    def wait_preload_done(self):
        return None

    def release_memory(self):
        self._samples = None
        self._perm = None
        self._stripe = None

    def get_memory_data_size(self, fleet=None):
        return 0 if self._samples is None else self._n_samples(self._samples)

    def get_shuffle_data_size(self, fleet=None):
        return self.get_memory_data_size(fleet)

    def local_shuffle(self):
        if self._samples is None:
            raise RuntimeError("call load_into_memory() first")
        rng = np.random.RandomState(self._epoch_seed)
        self._epoch_seed += 1
        self._perm = rng.permutation(self._n_samples(self._samples))

    def global_shuffle(self, fleet=None, thread_num=12):
        """The same seeded permutation in every process, then this process's
        stripe of rows (rank, rank + world, ...): a cross-process shuffle
        without a shuffle service. Both are views applied at batch time, so
        a call per epoch reshuffles the whole dataset."""
        if self._samples is None:
            raise RuntimeError("call load_into_memory() first")
        rng = np.random.RandomState(1000 + self._epoch_seed)
        self._epoch_seed += 1
        self._perm = rng.permutation(self._n_samples(self._samples))
        w, r = penv.get_world_size(), penv.get_rank()
        self._stripe = (r, w) if w > 1 else None


class QueueDataset(DatasetBase):
    """Streams its files: each file is parsed when it is reached and its
    batches go out at once, so the executor's prefetch thread parses file
    k + 1 while the steps of file k run. The rows a file leaves over carry
    into the next one, so the batches are those of the whole list."""

    def local_shuffle(self):
        raise ValueError("QueueDataset streams files; use InMemoryDataset for shuffling")

    def global_shuffle(self, fleet=None):
        raise ValueError("QueueDataset streams files; use InMemoryDataset")

    def _iter_batches(self):
        if self._samples is not None:   # loaded by hand: the in-memory path
            yield from DatasetBase._iter_batches(self)
            return
        self._reset_poison_window()
        names = [v.name for v in self.use_vars]
        bs = self.batch_size
        stripe = self._stripe
        row_base = 0                    # global row count, for the stripe
        rows_kept = 0                   # rows of this process
        pend: Optional[List[np.ndarray]] = None   # carried columns
        pend_rows: list = []                      # carried rows
        columnar_mode = None
        n_yielded = 0

        def flush(cols_or_rows, columnar, final=False):
            nonlocal pend, pend_rows
            if columnar:
                cols = cols_or_rows
                if pend is not None:
                    cols = [np.concatenate([p, c]) for p, c in zip(pend, cols)]
                n = cols[0].shape[0]
                stop = n if final else (n // bs) * bs
                for i in range(0, stop, bs):
                    if stop - i < bs and self.drop_last:
                        break
                    yield {nm: c[i:i + bs] for nm, c in zip(names, cols)}
                pend = None if final else [c[stop:] for c in cols]
            else:
                rows = pend_rows + cols_or_rows
                stop = len(rows) if final else (len(rows) // bs) * bs
                for i in range(0, stop, bs):
                    if stop - i < bs and self.drop_last:
                        break
                    yield self._stack_rows(names, rows[i:i + bs])
                pend_rows = [] if final else rows[stop:]

        for path in self.filelist:
            if not os.path.exists(path) and self._missing_file(path):
                continue
            cols = self._read_native(path)
            columnar = cols is not None
            if not columnar:
                cols = self._read_python(path)
            if columnar_mode is None:
                columnar_mode = columnar
            elif columnar_mode != columnar:
                # mixed native and Python files: rows from here on, the carried
                # columns demoted, so the batching stays that of the whole list
                if columnar:
                    cols = list(zip(*[list(c) for c in cols]))
                    columnar = False
                else:
                    if pend is not None:
                        pend_rows = list(zip(*[list(c) for c in pend]))
                        pend = None
                    columnar_mode = False
            n = cols[0].shape[0] if columnar else len(cols)
            if stripe is not None:
                r, w = stripe
                keep = np.arange(n)[(row_base + np.arange(n)) % w == r]
                cols = [c[keep] for c in cols] if columnar else [cols[int(k)] for k in keep]
                rows_kept += len(keep)
            else:
                rows_kept += n
            row_base += n
            for b in flush(cols, columnar_mode):
                n_yielded += 1
                yield b
        # one final flush of the carried rows, whether the last file streamed,
        # was skipped or the list was empty
        if pend is not None:
            tail = flush([c[:0] for c in pend], True, final=True)
        elif pend_rows:
            tail = flush([], False, final=True)
        else:
            tail = ()
        for b in tail:
            n_yielded += 1
            yield b
        if n_yielded == 0:
            warnings.warn(f"Dataset yields no batches: {rows_kept} samples on this host vs "
                          f"batch_size={bs}", UserWarning)


class DatasetFactory:
    def create_dataset(self, datafeed_class="QueueDataset"):
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        if datafeed_class == "QueueDataset":
            return QueueDataset()
        if datafeed_class == "StreamingDataset":
            # imported here: a run that never streams loads no reader machinery
            from .data import StreamingDataset
            return StreamingDataset()
        raise ValueError(f"unknown dataset class {datafeed_class!r}")
