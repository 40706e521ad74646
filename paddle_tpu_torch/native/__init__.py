"""The native slot parser, loaded with ctypes (the port's copy of
``paddle_tpu/native/__init__.py``: ``_load``, ``available``,
``parse_slot_file``).

``fast_parser.cpp`` beside this file parses rectangular slot-text lines
(``;``-separated slots, space-separated values) on C++ threads into one
float32 matrix. At its first use it is compiled with ``g++ -O3 -shared -fPIC
-std=c++17 -pthread`` into ``native/build/`` (git-ignored), under a name
that carries a digest of the source and the flags, as ``core/cuda_build.py``
names the kernels: an edited source is rebuilt, a built one reused, and
nothing is written beside the source. Where no library can be built or
loaded, ``parse_slot_file`` returns None and the datasets take the Python
parser, as the JAX package does; ``build_error`` then says why. ``parses``
counts the files this process parsed natively (``chip_smoke.py`` reads it:
on the card the native parser must be what ran).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "fast_parser.cpp"
BUILD_DIR = SOURCE.parent / "build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_LOCK = threading.Lock()
_LIB = None
_LIB_TRIED = False
#: why the library is unavailable (None: it loaded, or was not tried yet)
build_error: Optional[str] = None
#: files parsed natively by this process
parses = 0

_ERRORS = {-1: "cannot open {path!r}",
           -2: "{path!r}: ragged line (slots must be fixed-width, {n} ';'-separated "
               "slots per line)",
           -3: "{path!r}: parser buffer overflow",
           -4: "{path!r}: malformed float"}


def library_path() -> Path:
    """The library's path: its name carries a digest of the source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libfast_parser-{h.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    """g++ into a temporary name, then an atomic rename: a concurrent
    process sees the whole library or none."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE)],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, out)


def _load():
    global _LIB, _LIB_TRIED, build_error
    with _LOCK:
        if _LIB_TRIED:
            return _LIB
        _LIB_TRIED = True
        so = library_path()
        try:
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            build_error = f"{type(e).__name__}: {e} {detail.decode(errors='replace')}".strip()
            return None
        lib.parse_slot_file.restype = ctypes.c_int64
        lib.parse_slot_file.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def parse_slot_file(path: str, n_slots: int, n_threads: int = 0):
    """Parse a rectangular slot-text file natively: (rows, one float32
    [rows, width] array per slot), or None when the library is unavailable
    (the caller takes the Python parser). A file the parser refuses raises
    ValueError with the JAX package's texts."""
    global parses
    lib = _load()
    if lib is None:
        return None
    fsize = os.path.getsize(path)
    # every value takes at least 2 bytes of text ("0 "): fsize / 2 bounds the count
    cap = max(fsize // 2 + n_slots, 64)
    out = np.empty(cap, np.float32)
    widths = np.zeros(n_slots, np.int64)
    rows = lib.parse_slot_file(
        path.encode(), n_slots, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap,
        widths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n_threads)
    if rows < 0:
        msg = _ERRORS.get(int(rows))
        raise ValueError(msg.format(path=path, n=n_slots) if msg else f"error {rows}")
    with _LOCK:
        parses += 1
    stride = int(widths.sum())
    mat = out[:rows * stride].reshape(int(rows), stride)
    cols, off = [], 0
    for w in widths:
        cols.append(np.ascontiguousarray(mat[:, off:off + int(w)]))
        off += int(w)
    return int(rows), cols
