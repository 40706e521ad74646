"""The C serving ABI (``serving_capi.cpp`` beside this file), built with
``g++`` and loaded with ctypes.

``serving_capi.cpp`` is the port's copy of the JAX package's
``native/serving_capi.cpp``: the same ``extern "C"`` surface
(``pd_predictor_create``, ``pd_predictor_num_outputs``, ``pd_predictor_run``,
``pd_predictor_destroy``, ``pd_last_error``) over
``paddle_tpu_torch.inference.Predictor``, plus ``pd_predictor_create_on``,
which names the device (``"cpu"`` or ``"cuda"``) as the port's CLIs'
``--device`` does. ``pd_predictor_create`` serves on the card.

``library_path()`` names the library by a digest of the source, the flags,
the interpreter's header directory and its version: an edited source or
another interpreter gets a build of its own, a built one is reused. ``build``
compiles it into ``native/build/`` (git-ignored) at first use and raises
with ``g++``'s message when that fails; ``load`` returns the ctypes library
with every function's signature set. The library links no libpython: loaded
into a Python process it uses that interpreter (a C program links it with
``python3-config --ldflags --embed``).

    lib = capi.load()
    h = lib.pd_predictor_create(b"model_dir", b"")
    rc = capi.run(lib, h, {"x": x}, out)      # 0, or -1 / -2 / -3
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "serving_capi.cpp"
BUILD_DIR = SOURCE.parent / "build"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
#: largest output rank pd_predictor_run reports
MAX_RANK = 8

_LOCK = threading.Lock()
_LIB = None


def include_dir() -> str:
    """The running interpreter's headers (not ``python3-config``'s, which
    may name another CPython than the one that loads the library)."""
    return sysconfig.get_paths()["include"]


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS + (include_dir(), sys.version)).encode())
    return BUILD_DIR / f"libpaddle_tpu_torch_capi-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """The library's path, compiled with ``g++`` when it is not there yet
    (into a temporary name, then renamed: a concurrent process sees the whole
    library or none). A failed build raises RuntimeError with ``g++``'s
    message."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(SOURCE), f"-I{include_dir()}", "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"building the C serving ABI: {type(e).__name__}: {e}") from e
    if r.returncode != 0:
        raise RuntimeError(f"building the C serving ABI failed ({' '.join(cmd)}):\n"
                           f"{r.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The built library with its functions' signatures (loaded once)."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build()))
        lib.pd_predictor_create.restype = ctypes.c_void_p
        lib.pd_predictor_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.pd_predictor_create_on.restype = ctypes.c_void_p
        lib.pd_predictor_create_on.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                               ctypes.c_char_p]
        lib.pd_predictor_num_outputs.restype = ctypes.c_int
        lib.pd_predictor_num_outputs.argtypes = [ctypes.c_void_p]
        lib.pd_predictor_destroy.restype = None
        lib.pd_predictor_destroy.argtypes = [ctypes.c_void_p]
        lib.pd_predictor_run.restype = ctypes.c_int
        lib.pd_predictor_run.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]
        lib.pd_last_error.restype = ctypes.c_char_p
        lib.pd_last_error.argtypes = []
        _LIB = lib
        return lib


def run(lib, handle, feeds: Dict[str, np.ndarray], out: np.ndarray,
        out_index: int = 0) -> Tuple[int, tuple]:
    """One ``pd_predictor_run`` call as a C caller makes it: each feed a
    C-contiguous float32 array, output ``out_index`` written into the flat
    float32 ``out`` (its size is the capacity). (return code, output shape)."""
    arrays = [np.ascontiguousarray(v, np.float32) for v in feeds.values()]
    n = len(arrays)
    names = (ctypes.c_char_p * n)(*[k.encode() for k in feeds])
    datas = (ctypes.POINTER(ctypes.c_float) * n)(
        *[a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for a in arrays])
    ndims = (ctypes.c_int * n)(*[a.ndim for a in arrays])
    dims = [d for a in arrays for d in a.shape]
    shapes = (ctypes.c_longlong * max(len(dims), 1))(*dims)
    if out.dtype != np.float32 or not out.flags["C_CONTIGUOUS"]:
        raise ValueError("out must be a C-contiguous float32 array")
    out_shape = (ctypes.c_longlong * MAX_RANK)()
    out_ndim = ctypes.c_int(0)
    rc = lib.pd_predictor_run(
        handle, n, names, datas, ndims, shapes, out_index,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size,
        out_shape, ctypes.byref(out_ndim))
    return rc, tuple(out_shape[i] for i in range(out_ndim.value))
