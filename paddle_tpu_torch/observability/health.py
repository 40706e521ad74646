"""Tensor-health watchdog: one nonfinite scan a step (the port's copy of
``mode``, ``include_state``, ``nonfinite_names``, ``nonfinite_flags``,
``read_flags``, ``check_flag_matrix``, ``take_verdict`` and ``check`` of
``paddle_tpu/observability/health.py``).

``PADDLE_TPU_OBS_HEALTH=off|warn|raise`` (default off; ``1`` means warn)
arms a NaN/Inf scan over the fetches a step hands back and, with
``PADDLE_TPU_OBS_HEALTH_STATE=1``, the state it wrote. On the card the scan
is one packed flag vector, a flag per watched tensor reduced there, and one
device-to-host copy of it: never a ``.item()`` per tensor. Host (numpy)
values are checked on the host. The first offending tensor is attributed by
program label and variable name into the journal (``tensor_nonfinite``)
and ``tensor_nonfinite_total``; ``warn`` warns, ``raise`` raises
``FloatingPointError``. The verdict is stashed per program label for the
step guardian (``take_verdict``).

With the mode off (the default) nothing runs: no device work, no copy.
A fused call of K steps (``Executor.run_fused``) builds one flag row on
the device after each substep (``nonfinite_flags``: the fetches and, with
``PADDLE_TPU_OBS_HEALTH_STATE=1``, the state the substep wrote, before the
next substep updates it in place), stacks the K rows into one matrix and
copies it to the host once (``read_flags``); ``check_flag_matrix`` journals
the first substep at fault with ``substep`` and ``k``, as the JAX
package's scan does.
"""
from __future__ import annotations

import threading
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .journal import env_truthy as _env_truthy
from .journal import mode_env as _mode_env

MODES = ("off", "warn", "raise")

# unconsumed verdicts by program label (bounded; the oldest is dropped)
_verdict_lock = threading.Lock()
_verdicts: dict = {}
_VERDICT_CAP = 16


def take_verdict(program=None):
    """Return and clear the stashed verdict (``{"program", "where",
    "vars"}``) for the label ``program``, or the newest when None; None when
    there is nothing unconsumed for it."""
    with _verdict_lock:
        if program is None:
            if not _verdicts:
                return None
            program = next(reversed(_verdicts))
        return _verdicts.pop(program, None)


def _stash_verdict(program, where, bad):
    with _verdict_lock:
        _verdicts.pop(program, None)
        _verdicts[program] = {"program": program, "where": where, "vars": list(bad)}
        while len(_verdicts) > _VERDICT_CAP:
            _verdicts.pop(next(iter(_verdicts)))


def mode() -> str:
    return _mode_env("PADDLE_TPU_OBS_HEALTH", MODES)


def include_state() -> bool:
    return _env_truthy("PADDLE_TPU_OBS_HEALTH_STATE")


def _inexact(v) -> bool:
    if isinstance(v, torch.Tensor):
        return v.dtype.is_floating_point or v.dtype.is_complex
    dt = getattr(v, "dtype", None)
    return dt is not None and np.issubdtype(np.dtype(dt), np.inexact)


def nonfinite_names(named: Sequence[Tuple[str, object]]) -> List[str]:
    """Names of the non-finite tensors among ``named`` [(name, tensor or
    numpy array)]. Non-float entries are skipped. Host values are checked on
    the host; the tensors go through one reduction to a flag vector, copied
    to the host once."""
    watch = [(n, v) for n, v in named if _inexact(v)]
    if not watch:
        return []
    host = [(n, v) for n, v in watch if not isinstance(v, torch.Tensor)]
    dev = [(n, v) for n, v in watch if isinstance(v, torch.Tensor)]
    bad = {n for n, v in host if not np.isfinite(v).all()}
    if dev:
        with torch.no_grad():
            flags = torch.stack([torch.isfinite(v).all().logical_not()
                                 for _, v in dev]).cpu().numpy()
        bad.update(dev[i][0] for i in np.flatnonzero(flags))
    return [n for n, _ in watch if n in bad]


def nonfinite_flags(named: Sequence[Tuple[str, object]]):
    """One substep's row of a fused call's flags: ``(names, flags)``, the
    names of the floating tensors among ``named`` and a bool tensor on their
    device, True where one holds a NaN or Inf (None when nothing is
    watched). Nothing is read back to the host."""
    names, flags = [], []
    with torch.no_grad():
        for name, v in named:
            if isinstance(v, torch.Tensor) and _inexact(v):
                names.append(name)
                flags.append(torch.isfinite(v).all().logical_not())
    if not flags:
        return names, None
    return names, torch.stack(flags)


def read_flags(flags) -> np.ndarray:
    """The one device-to-host copy of a fused call's (K, n_watch) flag
    matrix (a function of its own, so a test can count the reads)."""
    if isinstance(flags, torch.Tensor):
        return flags.cpu().numpy()
    return np.asarray(flags)


def check_flag_matrix(flag_rows, names: Sequence[str], program: str,
                      where: str = "executor", health_mode: Optional[str] = None,
                      step0: int = 0) -> List[str]:
    """``check`` over a read (K, n_watch) flag matrix of a fused call: the
    same count, journal, warning or raise, and the journal event carries
    ``substep`` (``step0`` plus the first row at fault: the training step)
    and ``k``."""
    m = health_mode if health_mode is not None else mode()
    if m == "off" or flag_rows is None or not len(names):
        return []
    rows = np.asarray(flag_rows, dtype=bool).reshape(-1, len(names))
    hit_r, hit_c = np.nonzero(rows)
    if hit_r.size == 0:
        return []
    bad: List[str] = []
    for c in hit_c:
        if names[c] not in bad:
            bad.append(names[c])
    substep = int(step0) + int(hit_r[0])
    _stash_verdict(program, where, bad[:8])
    from . import journal as _journal
    from .metrics import REGISTRY
    REGISTRY.counter("tensor_nonfinite_total",
                     "tensors found NaN/Inf by the health watchdog",
                     where=where).inc(len(bad))
    _journal.emit({"event": "tensor_nonfinite", "program": program,
                   "where": where, "var": bad[0], "vars": bad[:8],
                   "substep": substep, "k": int(rows.shape[0])})
    msg = (f"NaN/Inf detected in {where} output {bad[0]!r} at substep "
           f"{substep} of a fused megastep (program {program}; "
           f"{len(bad)} tensor(s) affected: {bad[:8]})")
    if m == "raise":
        raise FloatingPointError(msg)
    warnings.warn(msg)
    return bad


def check(named: Sequence[Tuple[str, object]], program: str,
          where: str = "executor", health_mode: Optional[str] = None) -> List[str]:
    """Scan ``named``; attribute, count, journal, warn or raise. Returns the
    offending names (empty when healthy or the mode is off)."""
    m = health_mode if health_mode is not None else mode()
    if m == "off":
        return []
    bad = nonfinite_names(named)
    if not bad:
        return []
    _stash_verdict(program, where, bad[:8])
    from . import journal as _journal
    from .metrics import REGISTRY
    REGISTRY.counter("tensor_nonfinite_total",
                     "tensors found NaN/Inf by the health watchdog",
                     where=where).inc(len(bad))
    _journal.emit({"event": "tensor_nonfinite", "program": program,
                   "where": where, "var": bad[0], "vars": bad[:8]})
    msg = (f"NaN/Inf detected in {where} output {bad[0]!r} "
           f"(program {program}; {len(bad)} tensor(s) affected: {bad[:8]})")
    if m == "raise":
        raise FloatingPointError(msg)
    warnings.warn(msg)
    return bad
