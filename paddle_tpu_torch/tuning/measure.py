"""Timing harness for autotune searches (the port's copy of
``paddle_tpu/tuning/measure.py``).

Each candidate is measured on its own: ``bench`` builds fresh inputs from
the choice point's params (nothing shared with the run that asked), and
``time_callable`` calls the candidate ``warmup`` times, then ``iters``
timed times and takes the median. The first call is timed apart as
``compile_ms``: on the card it is where a kernel's module is loaded and
cuBLAS / cuDNN pick and set up their algorithms, the port's counterpart of
the JAX package's AOT compile. On the card every timed call is bracketed
by CUDA events on the current stream, queued behind a spin of the device
(``torch.cuda._sleep``) long enough for the host to enqueue the call, so
the events bracket the device's work and not the host's launches: the
time a captured graph's replay of the same work takes. On the CPU each call
is bracketed by ``time.perf_counter``.

A search never runs inside a CUDA-graph capture: measuring there would
record the candidates into the graph. ``decide()`` raises instead
(``choices.decide``); the executor and the Predictor make their decisions
in the eager warm-up run before each capture.

Results flow through the observability registry, as in the JAX package:

- ``autotune_decisions_total{choice,source}`` counts every ``decide()``
  answer by where it came from (default | cached | search);
- ``autotune_search_seconds`` histograms the wall cost of each search;
- one ``autotune`` journal event per search records the winner AND the
  losers with their timings, so a decision is always auditable.

Tests inject deterministic timings by monkeypatching ``time_callable``.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

from ..observability import journal as _journal
from ..observability.metrics import REGISTRY as _OBS

#: measurement schedule; the CLI can widen it for noisy hosts
WARMUP = 1
ITERS = 5
#: device cycles the card spins before each timed call (~1 ms at H100 clocks)
SPIN_CYCLES = 2_000_000


class CandidateFailed(RuntimeError):
    """A candidate of a search failed to build or to run."""


def _device_of(args) -> Optional[Any]:
    """The CUDA device of the first CUDA tensor among ``args`` (nested in
    lists, tuples and dicts), else None."""
    import torch
    stack = list(args)
    while stack:
        a = stack.pop(0)
        if isinstance(a, torch.Tensor):
            if a.is_cuda:
                return a.device
        elif isinstance(a, (list, tuple)):
            stack.extend(a)
        elif isinstance(a, dict):
            stack.extend(a.values())
    return None


def time_callable(fn: Callable[..., Any], args: tuple,
                  warmup: int = None, iters: int = None) -> Dict[str, float]:
    """Measure one candidate: ``fn(*args)``.

    Returns ``{"compile_ms", "run_ms", "runs_ms"}``: ``compile_ms`` is the
    first call alone, ``run_ms`` the median of ``iters`` timed calls after
    ``warmup`` more untimed ones. CUDA events time the calls when an
    argument lies on the card, ``perf_counter`` otherwise."""
    import torch
    warmup = WARMUP if warmup is None else warmup
    iters = ITERS if iters is None else iters
    dev = _device_of(args)
    if dev is not None and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("autotune: a candidate cannot be timed inside a CUDA-graph "
                           "capture")
    runs: List[float] = []
    if dev is None:
        t0 = time.perf_counter()
        fn(*args)
        compile_ms = (time.perf_counter() - t0) * 1e3
        for _ in range(max(0, warmup - 1)):
            fn(*args)
        for _ in range(max(1, iters)):
            t = time.perf_counter()
            fn(*args)
            runs.append((time.perf_counter() - t) * 1e3)
    else:
        with torch.cuda.device(dev):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize(dev)
            compile_ms = (time.perf_counter() - t0) * 1e3
            for _ in range(max(0, warmup - 1)):
                fn(*args)
            torch.cuda.synchronize(dev)
            for _ in range(max(1, iters)):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(SPIN_CYCLES)
                a.record()
                fn(*args)
                b.record()
                b.synchronize()
                runs.append(a.elapsed_time(b))
    runs.sort()
    return {"compile_ms": compile_ms, "run_ms": runs[len(runs) // 2], "runs_ms": runs}


def search(choice, params: dict, key: str,
           warmup: Optional[int] = None,
           iters: Optional[int] = None) -> dict:
    """Measure every candidate of ``choice`` for ``params``; return the
    decision record (winner + per-candidate timings) that cache.py persists.

    A candidate whose bench builder returns None (unmeasurable here) is
    recorded as skipped and left out of the vote; the default stands when
    no candidate could be measured. A candidate whose build or measurement
    raises stops the search with ``CandidateFailed``: a kernel that does not
    build or launch is a fault, and letting the other candidates win would
    route the op away from it. The failure is journalled and nothing is
    cached. Ties break toward the earlier candidate in the choice point's
    declared order (deterministic across repeats)."""
    candidates = choice.candidates(params)
    t_search = time.perf_counter()
    timings: Dict[str, dict] = {}
    best = None
    best_ms = None
    for cand in candidates:
        crepr = choice.encode(cand)
        try:
            built = choice.bench(params, cand)
            if built is None:
                timings[crepr] = {"skipped": "unmeasurable on this host"}
                continue
            fn, args = built
            t = time_callable(fn, args, warmup=warmup, iters=iters)
        except Exception as e:
            _journal.emit({"event": "autotune", "choice": choice.id, "key": key,
                           "failed": crepr, "error": str(e)[:500]})
            raise CandidateFailed(
                f"autotune: candidate {crepr!r} of {choice.id} at {key} failed: {e}") from e
        timings[crepr] = t
        if best_ms is None or t["run_ms"] < best_ms:
            best, best_ms = cand, t["run_ms"]
    search_s = time.perf_counter() - t_search
    measured = best is not None
    if not measured:
        # nothing measurable: the static default, with the attempt recorded so
        # that cached mode does not retry the search every run
        best = choice.default(params)
    record = {
        "choice": choice.id,
        "winner": choice.encode(best),
        "measured": measured,
        "timings": timings,
        "search_seconds": round(search_s, 6),
        "ts": time.time(),
    }
    _OBS.histogram("autotune_search_seconds",
                   "wall time of one autotune candidate search"
                   ).observe(search_s)
    _journal.emit({"event": "autotune", "choice": choice.id, "key": key,
                   "winner": record["winner"], "measured": measured,
                   "timings": timings,
                   "search_ms": round(search_s * 1e3, 3)})
    return record
