"""Unique name generator (reference: python/paddle/fluid/unique_name.py)."""
from __future__ import annotations

import threading
from collections import defaultdict
from contextlib import contextmanager


class UniqueNameGenerator:
    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.ids = defaultdict(int)

    def __call__(self, key: str) -> str:
        i = self.ids[key]
        self.ids[key] += 1
        return f"{self.prefix}{key}_{i}"


class _TLS(threading.local):
    def __init__(self):
        self.generator = UniqueNameGenerator()


_tls = _TLS()


def generate(key: str) -> str:
    return _tls.generator(key)


@contextmanager
def guard(prefix: str = ""):
    old = _tls.generator
    _tls.generator = UniqueNameGenerator(prefix)
    try:
        yield
    finally:
        _tls.generator = old


def switch(generator: UniqueNameGenerator | None = None) -> UniqueNameGenerator:
    old = _tls.generator
    _tls.generator = generator or UniqueNameGenerator()
    return old
