"""Filesystem hook for checkpoint and model IO (the port's copy of
``paddle_tpu/utils/fs.py``).

Local paths use the standard library; any path with a URL scheme
("hdfs://...", "gs://...", "s3://...") dispatches through ``fsspec``, as
the JAX package's does. Without ``fsspec`` installed a scheme'd path raises
its ``ImportError``: nothing falls back to a local path.

Every helper accepts both plain paths and scheme'd URLs, so ``io.py`` and
``Checkpointer`` call these unconditionally.
"""
from __future__ import annotations

import os
import shutil
from typing import IO, List


def is_remote(path) -> bool:
    return "://" in str(path)


def _fs(path):
    import fsspec
    fs, _ = fsspec.core.url_to_fs(str(path))
    return fs


def join(*parts) -> str:
    if is_remote(parts[0]):
        base = str(parts[0]).rstrip("/")
        return "/".join([base] + [str(p).strip("/") for p in parts[1:]])
    return os.path.join(*parts)


def open_file(path, mode: str = "r") -> IO:
    if is_remote(path):
        import fsspec
        return fsspec.open(str(path), mode).open()
    return open(path, mode)


def exists(path) -> bool:
    if is_remote(path):
        return _fs(path).exists(str(path))
    return os.path.exists(path)


def makedirs(path, exist_ok: bool = True):
    if is_remote(path):
        _fs(path).makedirs(str(path), exist_ok=exist_ok)
        return
    os.makedirs(path, exist_ok=exist_ok)


def listdir(path) -> List[str]:
    if is_remote(path):
        return [p.rstrip("/").rsplit("/", 1)[-1]
                for p in _fs(path).ls(str(path), detail=False)]
    return os.listdir(path)


def rmtree(path, ignore_errors: bool = True):
    if is_remote(path):
        try:
            _fs(path).rm(str(path), recursive=True)
        except Exception:
            if not ignore_errors:
                raise
        return
    shutil.rmtree(path, ignore_errors=ignore_errors)


def replace(src, dst):
    """Atomic-on-local rename; copy-then-delete on remote stores (object
    stores have no rename -- callers tolerate the non-atomic window there,
    as the reference's hdfs mv does)."""
    if is_remote(src) or is_remote(dst):
        fs = _fs(dst)
        try:
            fs.mv(str(src), str(dst))
        except Exception:
            fs.copy(str(src), str(dst))
            fs.rm(str(src))
        return
    os.replace(src, dst)


def file_size(path):
    """Size in bytes, or None when the store does not report one (some
    fsspec backends omit ``size`` from info()) -- callers must treat None
    as "unknown", never as 0."""
    if is_remote(path):
        size = _fs(path).info(str(path)).get("size")
        return None if size is None else int(size)
    return os.path.getsize(path)


def read_bytes(path) -> bytes:
    with open_file(path, "rb") as f:
        return f.read()


def write_bytes(path, data: bytes):
    with open_file(path, "wb") as f:
        f.write(data)


def move(src, dst):
    """Rename a file OR directory (``replace`` is file-shaped: fsspec mv
    without recursive=True does not move directory trees).  Local is an
    atomic os.replace; remote is mv/copy+delete like ``replace``."""
    if is_remote(src) or is_remote(dst):
        fs = _fs(dst)
        try:
            fs.mv(str(src), str(dst), recursive=True)
        except Exception:
            fs.copy(str(src), str(dst), recursive=True)
            fs.rm(str(src), recursive=True)
        return
    os.replace(src, dst)


def save_array(path, arr):
    """np.save through the hook (np.save writes to file objects)."""
    import numpy as np
    if is_remote(path):
        p = str(path)
        if not p.endswith(".npy"):
            p += ".npy"
        with open_file(p, "wb") as f:
            np.save(f, arr, allow_pickle=False)
        return
    np.save(path, arr, allow_pickle=False)


def load_array(path, mmap: bool = True):
    """np.load; local paths may memory-map, remote streams the bytes."""
    import numpy as np
    if is_remote(path):
        p = str(path)
        if not p.endswith(".npy"):
            p += ".npy"
        with open_file(p, "rb") as f:
            return np.load(f, allow_pickle=False)
    return np.load(path, mmap_mode="r" if mmap else None,
                   allow_pickle=False)
