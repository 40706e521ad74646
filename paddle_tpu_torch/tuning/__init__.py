"""Empirical autotuner: measure-and-cache route, tile and layout selection
(the port's copy of ``paddle_tpu/tuning/``).

Which of the port's routes runs a shape fastest on this card (a kernel
tile, a memory layout, the steps a ``run_fused`` call takes; on the CPU also
a kernel's plain version against the PyTorch chain it replaces) is
per-shape and per-card, and only measurement finds it. On the card a plain
PyTorch chain is never a candidate: no decision routes an op away from its
kernel. This package is the layer between
the op lowerings and the executor's graph cache that makes that
measurement systematic:

- ``choices``  -- the ``TunableChoice`` registry; the choice points
  (conv2d_bn_fused backend, fused_attention backend, K1-fwd's query tile,
  conv2d compute layout, fuse_steps K), consulted by the op lowerings and
  the executor via ``decide()`` (the backends only where they have more
  than one candidate: the conv+BN backend on the CPU);
- ``measure``  -- the timing harness (fresh inputs, first call timed apart,
  warmup + median of CUDA-event-timed calls on the card), journaling every
  search through the observability registry;
- ``cache``    -- in-memory + atomic on-disk decision cache keyed by
  (choice id, shape bucket, dtype, card name, torch/CUDA versions), gated by
  ``PADDLE_TPU_TUNE=off|cached|search`` (default ``cached``: persisted
  decisions apply, zero measurement work, zero hot-path file I/O).

The lowerings consult ``decide()`` every time they run, and a decision is a
dict lookup once made; on the card a step or a request runs its lowerings
eagerly once before it is captured as a CUDA graph, so a search happens in
that eager run and the capture and every replay reuse its answer.
Offline, ``python -m paddle_tpu_torch.tuning`` pre-tunes a serialized
program or the built-in suites and prints a decision report.
"""
from __future__ import annotations

from typing import List, Optional

from . import cache  # noqa: F401
from . import choices  # noqa: F401
from . import measure  # noqa: F401
from .cache import DecisionCache, mode, state_token  # noqa: F401
from .choices import (TunableChoice, decide, device_kind,  # noqa: F401
                      get_choice, list_choices, register_choice)


def prefetch() -> None:
    """Load the on-disk decision cache (once per process) unless tuning is
    off. The executor calls this BEFORE building a step's graph key, so the
    lowerings' ``decide()`` consults are pure in-memory lookups and the
    key's ``state_token()`` is stable across the miss."""
    if cache.mode() != "off":
        cache.CACHE.load()


def record_decision(choice_id: str, params: dict, winner,
                    timings: Optional[dict] = None,
                    search_seconds: Optional[float] = None,
                    measured: bool = True) -> dict:
    """Persist an EXTERNALLY measured decision for ``choice_id``.

    The door for choice points whose candidates cannot be measured in
    ``measure.search``'s isolated run -- ``fuse_steps.k`` is measured by
    ``Executor.train_from_dataset`` on the live workload (the search's
    ``run_fused`` calls are real training steps) and recorded here.  Journals the
    same auditable ``autotune`` event a harness search would."""
    import time as _time
    from ..observability import journal as _journal
    ch = get_choice(choice_id)
    key = ch.key(params)
    rec = {"choice": choice_id, "winner": ch.encode(winner),
           "measured": bool(measured), "timings": dict(timings or {}),
           "search_seconds": (round(float(search_seconds), 6)
                              if search_seconds is not None else None),
           "ts": _time.time()}
    cache.CACHE.put(key, rec)
    _journal.emit({"event": "autotune", "choice": choice_id, "key": key,
                   "winner": rec["winner"], "measured": rec["measured"],
                   "timings": rec["timings"],
                   "search_ms": (round(float(search_seconds) * 1e3, 3)
                                 if search_seconds is not None else None)})
    return rec


#: the conv+BN suite: the (M, K, N) of ResNet-50's 1x1 conv+BN chains at
#: batch 128, 224 x 224 (each stage's first 1x1 and its expansion; the
#: shapes of the port's fused chains, ``chip_smoke.resnet_fused_shapes``)
RESNET_CONV_BN_SHAPES = (
    (401408, 64, 256),
    (401408, 256, 64),
    (100352, 512, 128),
    (25088, 1024, 256),
    (6272, 2048, 512),
)

#: flash-attention suite: BERT-like heads (H=12, D=64) with B*S pinned at
#: 16k tokens, across the port's serving and training lengths
FLASH_SUITE_S = (128, 512, 1024, 2048)


def _suite_dtype() -> str:
    import torch
    return "bfloat16" if torch.cuda.is_available() else "float32"


def _report_entry(choice_id: str, params: dict, winner, source: str) -> dict:
    ch = get_choice(choice_id)
    key = ch.key(params)
    rec = cache.CACHE.get(key) or {}
    return {"choice": choice_id, "key": key, "winner": ch.encode(winner),
            "source": source, "timings": rec.get("timings", {}),
            "measured": rec.get("measured"),
            "search_seconds": rec.get("search_seconds")}


def _tune_one(choice_id: str, params: dict, mode: Optional[str]) -> dict:
    before = cache.CACHE.get(get_choice(choice_id).key(params))
    winner = decide(choice_id, params, mode=mode)
    after = cache.CACHE.get(get_choice(choice_id).key(params))
    # "search" means MEASURED here; a search in which no candidate could be
    # measured persists a measured=False record (so cached mode won't retry
    # it every compile) and reports as "fallback", not as a fresh result
    if before is not None:
        source = "cached"
    elif after is not None:
        source = "search" if after.get("measured") else "fallback"
    else:
        source = "default"
    return _report_entry(choice_id, params, winner, source)


def tune_suite(suite: str = "all", mode: Optional[str] = "search",
               dtype: Optional[str] = None) -> List[dict]:
    """Pre-tune the built-in shape suites; returns one report entry per
    decision. ``suite``: ``resnet`` (conv+BN bottleneck shapes), ``flash``
    (attention backend + block sizes), or ``all``."""
    if suite not in ("resnet", "flash", "all"):
        raise ValueError(f"unknown suite {suite!r}; use resnet|flash|all")
    dt = dtype or _suite_dtype()
    out = []
    if suite in ("resnet", "all"):
        for m, k, n in RESNET_CONV_BN_SHAPES:
            out.append(_tune_one("conv2d_bn_fused.backend",
                                 {"m": m, "k": k, "n": n, "dtype": dt}, mode))
    if suite in ("flash", "all"):
        for s in FLASH_SUITE_S:
            params = {"b": max(1, 16384 // s), "h": 12, "s": s, "d": 64,
                      "dtype": dt, "has_bias": False, "dropout": 0.0,
                      "causal": False}
            out.append(_tune_one("fused_attention.backend", params, mode))
            if "kernel" in get_choice(
                    "fused_attention.backend").candidates(params):
                out.append(_tune_one("fused_attention.block_sizes", params,
                                     mode))
    return out


def _subst_batch(shape, batch: int) -> List[int]:
    return [int(batch) if int(d) < 0 else int(d) for d in shape]


def tune_program(program, batch: int = 128,
                 mode: Optional[str] = "search") -> List[dict]:
    """Walk ``program``'s ops and pre-tune every tunable choice point found
    (conv2d_bn_fused, fused_attention, conv2d/depthwise_conv2d), deriving
    shapes from the program's declared var shapes with dynamic (-1) dims
    substituted by ``batch``. Returns one report entry per decision. The
    params are the ones the lowerings build at run time, so a decision made
    here is the one a run of the program finds."""
    out = []
    seen = set()

    def _var_shape(block, name):
        v = block.find_var_recursive(name)
        return None if v is None or not v.shape else _subst_batch(
            v.shape, batch)

    for block in program.blocks:
        for op in block.ops:
            if op.type == "conv2d_bn_fused":
                x = _var_shape(block, op.inputs["Input"][0])
                w = _var_shape(block, op.inputs["Filter"][0])
                if not x or not w or len(x) != 4:
                    continue
                m = x[0] * x[1] * x[2]
                params = {"m": m, "k": x[3], "n": w[0],
                          "dtype": _var_dtype(block, op.inputs["Input"][0])}
                if _mark(seen, "conv2d_bn_fused.backend", params):
                    out.append(_tune_one("conv2d_bn_fused.backend", params,
                                         mode))
            elif op.type == "fused_attention":
                q = _var_shape(block, op.inputs["Q"][0])
                if not q or len(q) != 4:
                    continue
                has_bias = bool(op.inputs.get("Bias", [None])[0])
                params = {"b": q[0], "h": q[1], "s": q[2], "d": q[3],
                          "dtype": _var_dtype(block, op.inputs["Q"][0]),
                          "has_bias": has_bias,
                          "dropout": 0.0 if op.attr("is_test", False)
                          else float(op.attr("dropout_prob", 0.0) or 0.0),
                          "causal": bool(op.attr("causal", False))}
                if _mark(seen, "fused_attention.backend", params):
                    out.append(_tune_one("fused_attention.backend", params,
                                         mode))
                if "kernel" in get_choice(
                        "fused_attention.backend").candidates(params):
                    if _mark(seen, "fused_attention.block_sizes", params):
                        out.append(_tune_one("fused_attention.block_sizes",
                                             params, mode))
            elif op.type in ("conv2d", "depthwise_conv2d"):
                x = _var_shape(block, op.inputs["Input"][0])
                w = _var_shape(block, op.inputs["Filter"][0])
                if not x or not w or len(x) != 4:
                    continue
                fmt = op.attr("data_format", "NCHW") or "NCHW"
                groups = op.attr("groups", 1) or 1
                if op.type == "depthwise_conv2d":
                    groups = x[1] if fmt == "NCHW" else x[-1]
                # normalize attrs EXACTLY like the runtime lowering
                # (nn_ops._pair accepts scalars and lists): the key derived
                # here must be the one the lowering's consult derives, or
                # offline pre-tuning is silently wasted
                from ..ops.nn_ops import _pair
                params = {"x_shape": tuple(x), "w_shape": tuple(w),
                          "strides": tuple(_pair(op.attr("strides", [1, 1])
                                                 or [1, 1])),
                          "pads": list(_pair(op.attr("paddings", [0, 0])
                                             or [0, 0])),
                          "dils": tuple(_pair(op.attr("dilations", [1, 1])
                                              or [1, 1])),
                          "groups": groups, "fmt": fmt,
                          "dtype": _var_dtype(block, op.inputs["Input"][0])}
                if _mark(seen, "conv2d.layout", params):
                    out.append(_tune_one("conv2d.layout", params, mode))
    return out


def _var_dtype(block, name) -> str:
    v = block.find_var_recursive(name)
    return str(getattr(v, "dtype", None) or "float32")


def _mark(seen: set, choice_id: str, params: dict) -> bool:
    key = get_choice(choice_id).key(params)
    if key in seen:
        return False
    seen.add(key)
    return True
