"""Build the port's hand-written CUDA kernels and load them with ctypes.

Each ``paddle_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` into its own shared library under
``paddle_tpu_torch/csrc/build/`` (git-ignored); ``csrc/*.cuh`` are headers
the sources share. The library's file name carries a hash of the source and
the headers, so an edited kernel is rebuilt and a built one is reused. Nothing is built at import: the first CUDA call of a wrapper
builds its kernel, and ``build()`` builds several at once, one ``nvcc`` per
source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

#: the kernels, one ``csrc/<name>.cu`` each
SOURCES = ("conv1x1_bn", "flash_attn_bwd", "flash_attn_fwd", "int8_matmul",
           "multi_tensor_update")
#: the kernel wrappers (``counted``); a CUDA-graph replay adds what its
#: capture launched to each one's ``launches``
COUNTED: List[Callable] = []

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (ptxas register/spill report) of the builds this process ran
build_logs: Dict[str, str] = {}


def counted(fn: Callable) -> Callable:
    """Register kernel wrapper ``fn``: it adds one to ``fn.launches`` (from 0)
    where it launches its kernel, and nowhere else."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME); the "
                       "port's CUDA kernels are compiled on first use")


def library_path(name: str) -> Path:
    """The library's path: its name carries a hash of the source, the shared
    headers (``csrc/*.cuh``) and the target flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every named kernel whose library is missing, one ``nvcc`` per
    source in parallel. Returns name -> library path; raises with nvcc's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _loaded[name] = lib
    return lib
