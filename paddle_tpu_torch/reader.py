"""Input pipeline: ``DataLoader`` with a producer thread, ``PyReader``,
``DataFeeder`` and the reader decorators (the port's copy of
``paddle_tpu/reader.py``).

A producer thread runs the user's generator ahead of the training loop
through a bounded queue and yields feed dicts for ``Executor.run``. With
``use_double_buffer`` and a loader placed on the card, the producer stages
each numpy array into pinned host memory, so that the consumer's copy to
the card reads page-locked memory; the copy itself stays on the consuming
thread, on the stream the executor runs on. On the CPU (``places=
CPUPlace()``) the arrays go through as they are. In a multi-process job
(``parallel.env``: ``PADDLE_TRAINERS_NUM`` and the like) each process feeds
its rows of the global batch.
"""
from __future__ import annotations

import itertools
import queue
import random as _random
import threading
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch

from .core.executor import resolve_device
from .framework import Variable
from .parallel import env as penv


class DataLoader:
    """Iterable feeder: yields feed dicts ready for ``Executor.run``."""

    def __init__(self, feed_list: Sequence[Variable], capacity: int = 4,
                 return_list: bool = False, use_double_buffer: bool = True,
                 shard_by_host: Optional[bool] = None):
        self.feed_list = list(feed_list)
        self.capacity = capacity
        self.use_double_buffer = use_double_buffer
        # the generator yields the global batch in every process and each one
        # feeds its rows; None: on when the job has more than one process
        self.shard_by_host = shard_by_host
        self._batch_fn: Optional[Callable[[], Iterable]] = None
        self._places = None

    @staticmethod
    def from_generator(feed_list, capacity=4, use_double_buffer=True, iterable=True,
                       return_list=False, shard_by_host=None):
        return DataLoader(feed_list, capacity, return_list, use_double_buffer, shard_by_host)

    def set_batch_generator(self, fn, places=None):
        """fn() yields tuples or lists of arrays in ``feed_list`` order."""
        self._batch_fn, self._places = fn, places
        return self

    def set_sample_list_generator(self, fn, places=None):
        """fn() yields lists of samples, each a tuple in ``feed_list`` order."""
        def batches():
            for sample_list in fn():
                yield [np.asarray(c) for c in zip(*sample_list)]
        self._batch_fn, self._places = batches, places
        return self

    def set_sample_generator(self, fn, batch_size, drop_last=True, places=None):
        """fn() yields samples; ``batch_size`` of them make a batch."""
        def batches():
            buf = []
            for sample in fn():
                buf.append(sample if isinstance(sample, (tuple, list)) else (sample,))
                if len(buf) == batch_size:
                    yield [np.asarray(c) for c in zip(*buf)]
                    buf = []
            if buf and not drop_last:
                yield [np.asarray(c) for c in zip(*buf)]
        self._batch_fn, self._places = batches, places
        return self

    def _pins(self) -> bool:
        """Whether the producer stages into pinned memory: with
        ``use_double_buffer``, for a loader placed on the card (``places``
        None is the card, as for the ``Executor``)."""
        if not self.use_double_buffer:
            return False
        place = self._places[0] if isinstance(self._places, (list, tuple)) else self._places
        return resolve_device(place).type == "cuda"

    def __iter__(self):
        if self._batch_fn is None:
            raise RuntimeError("DataLoader has no generator; call "
                               "set_batch_generator/set_sample_generator first")
        names = [v.name for v in self.feed_list]
        pin = self._pins()
        world = penv.get_world_size()
        shard = world > 1 and (self.shard_by_host is None or self.shard_by_host)
        rank = penv.get_rank()
        q: "queue.Queue" = queue.Queue(maxsize=self.capacity)
        end = object()
        stop = threading.Event()
        exc: List[BaseException] = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch in self._batch_fn():
                    vals = list(batch)
                    if shard:   # only arrays with a leading (batch) dimension
                        vals = [penv.shard_batch(v, rank, world) if getattr(v, "ndim", 0) > 0
                                else v for v in vals]
                    if pin:
                        vals = [torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                                if isinstance(v, np.ndarray) else v for v in vals]
                    if not put(dict(zip(names, vals))):
                        return
            except BaseException as e:  # noqa: BLE001 -- raised again in the consumer
                exc.append(e)
            finally:
                put(end)

        t = threading.Thread(target=producer, daemon=True, name="dataloader-producer")
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    if exc:
                        raise exc[0]
                    return
                yield item
        finally:
            stop.set()


class PyReader(DataLoader):
    """The legacy reader facade."""

    def decorate_batch_generator(self, fn, places=None):
        return self.set_batch_generator(fn, places)

    def decorate_sample_list_generator(self, fn, places=None):
        return self.set_sample_list_generator(fn, places)


class DataFeeder:
    """Samples -> a feed dict: one numpy array per feed variable, float
    columns cast to the variable's dtype (bf16 as float32)."""

    def __init__(self, feed_list, place=None, program=None):
        self.feed_list = [v if isinstance(v, Variable) else None for v in feed_list]
        self.names = [v.name if isinstance(v, Variable) else str(v) for v in feed_list]

    def feed(self, iterable):
        out = {}
        for name, col, var in zip(self.names, zip(*iterable), self.feed_list):
            arr = np.asarray(col)
            if var is not None and var.dtype and arr.dtype.kind == "f":
                arr = arr.astype(var.dtype if var.dtype != "bfloat16" else "float32")
            out[name] = arr
        return out


# -- reader decorators: a reader is a callable returning an iterator -----------------------

def batch(reader, batch_size, drop_last=False):
    def batched():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf
    return batched


def shuffle(reader, buf_size, seed=None):
    rng = _random.Random(seed)

    def shuffled():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                yield from buf
                buf = []
        rng.shuffle(buf)
        yield from buf
    return shuffled


def cache(reader):
    all_data: List = []
    filled = []

    def cached():
        if not filled:
            all_data.extend(reader())
            filled.append(True)
        yield from all_data
    return cached


def firstn(reader, n):
    def first():
        yield from itertools.islice(reader(), n)
    return first


def map_readers(func, *readers):
    def mapped():
        for items in zip(*[r() for r in readers]):
            yield func(*items)
    return mapped


def chain(*readers):
    def chained():
        for r in readers:
            yield from r()
    return chained


def compose(*readers):
    def composed():
        for items in zip(*[r() for r in readers]):
            out = []
            for it in items:
                if isinstance(it, tuple):
                    out.extend(it)
                else:
                    out.append(it)
            yield tuple(out)
    return composed


def buffered(reader, size):
    """The reader's items, produced ahead by a thread through a queue of ``size``."""
    def buf():
        q: "queue.Queue" = queue.Queue(maxsize=size)
        end = object()

        def produce():
            for item in reader():
                q.put(item)
            q.put(end)

        threading.Thread(target=produce, daemon=True).start()
        while True:
            item = q.get()
            if item is end:
                return
            yield item
    return buf


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """``mapper`` over the reader's items on ``process_num`` threads; the
    results come back in the reader's order."""
    def mapped():
        items = list(reader())
        results: List = [None] * len(items)
        idx_q: "queue.Queue" = queue.Queue()
        for i in range(len(items)):
            idx_q.put(i)

        def work():
            while True:
                try:
                    i = idx_q.get_nowait()
                except queue.Empty:
                    return
                results[i] = mapper(items[i])

        threads = [threading.Thread(target=work) for _ in range(process_num)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        yield from results
    return mapped


def shard(reader, num_shards, shard_id):
    """Every ``num_shards``-th item from ``shard_id``: one process's share."""
    def sharded():
        for i, item in enumerate(reader()):
            if i % num_shards == shard_id:
                yield item
    return sharded
