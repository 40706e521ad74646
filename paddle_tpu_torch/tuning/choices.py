"""Tunable choice points + the ``decide()`` front door (the port's copy of
``paddle_tpu/tuning/choices.py``).

A ``TunableChoice`` names one degree of freedom the op library cannot pick
statically: which of the port's own routes (a hand-written kernel or the
PyTorch chain it replaces, a kernel tile, a memory layout) runs a shape on
this card. Each choice point declares

- ``bucket(params)``     -- the shape bucket that keys its decisions
                            (batch-like dims round up to powers of two so
                            near-miss batch sizes share one decision); the
                            same dict as the JAX package's for the same params;
- ``candidates(params)`` -- the legal candidates for these params;
- ``default(params)``    -- the answer when tuning is off or no decision is
                            cached: ALWAYS what the port did before the
                            autotuner, so ``PADDLE_TPU_TUNE=off`` is exactly
                            the old path;
- ``bench(params, cand)``-- ``(fn, args)`` measured by measure.py, or None
                            when the candidate cannot be measured in isolation;
- ``encode/decode``      -- the stable string form persisted in the JSON
                            decision cache.

The wired choice points, over the port's routes (no TPU crossover, gate or
tile is copied: the candidates are what the port can run, the defaults what
it ran):

==============================  =============================================
``conv2d_bn_fused.backend``     ``kernel`` (K2, ``csrc/conv1x1_bn.cu``; its
                                plain version on the CPU) or, on the CPU
                                only, ``unfused`` (``torch.matmul`` + the
                                batch statistics in f32) for the train-mode op
``fused_attention.backend``     ``kernel`` (K1, ``csrc/flash_attn_*.cu``) or,
                                on the CPU only, ``composed``
                                (``attention_plain``) at ``impl="auto"``
``fused_attention.block_sizes`` K1-fwd's (query rows, keys) a block: (128,
                                64) or (64, 64) for bf16; f32 has one tile
``conv2d.layout``               cuDNN on the declared layout or on the other
                                (``torch.channels_last`` against contiguous
                                NCHW), transposing at the op boundary
``fuse_steps.k``                steps a ``run_fused`` call takes in
                                ``train_from_dataset(fuse_steps=0)``; measured
                                in the loop by the executor
==============================  =============================================

On the card a choice offers hand-written routes only: a plain PyTorch chain
is never a candidate there, so no decision can route an op on CUDA tensors
away from its kernel. The backend choices thus have one candidate on the
card, the kernel; the tile and layout choices keep theirs.

``comm.compress`` is the per-tensor on/off of the compressed data-parallel
gradient all-reduce (``comm/rewrite.py``). The JAX package's
``shardplan.plan`` choice belongs to the auto-sharding planner, which the port
does not have yet (ROADMAP item 13 (c)).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

from ..observability.metrics import REGISTRY as _OBS
from . import cache as _cache
from . import measure as _measure


def pow2_bucket(n: int) -> int:
    """Round up to a power of two (1 -> 1, 24 -> 32): batch-like dims vary
    freely across runs and must not each earn a separate search."""
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


@functools.lru_cache(maxsize=None)
def device_kind() -> str:
    """The card's name (``torch.cuda.get_device_name``), ``cpu`` without one."""
    import torch
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"


@functools.lru_cache(maxsize=None)
def versions() -> str:
    """The torch and CUDA versions a decision was measured under."""
    import torch
    return f"torch{torch.__version__}+cuda{torch.version.cuda}"


def dtype_name(t) -> str:
    """A tensor's dtype as the program names it (``float32``, ``bfloat16``):
    the dtype a lowering puts in a choice's params, as ``tune_program`` reads
    it off the program's variables."""
    return str(t.dtype).replace("torch.", "")


def on_card() -> bool:
    """Whether candidates are measured, and CUDA routes chosen, on a card."""
    import torch
    return torch.cuda.is_available()


def _bench_device():
    """Where a candidate is measured: the current card, else the CPU."""
    import torch
    if on_card():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _zeros(shape, dtype):
    import torch
    from ..core.registry import torch_dtype
    return torch.zeros(tuple(int(d) for d in shape), dtype=torch_dtype(dtype),
                       device=_bench_device())


class TunableChoice:
    """Base class; subclasses set ``id`` and implement the hooks."""

    id: str = ""
    doc: str = ""

    def bucket(self, params: dict):
        raise NotImplementedError

    def candidates(self, params: dict) -> List[Any]:
        raise NotImplementedError

    def default(self, params: dict):
        raise NotImplementedError

    def bench(self, params: dict, candidate):
        """(fn, args) for measure.time_callable, or None if unmeasurable."""
        return None

    # decisions persist as strings; keep them stable across versions
    def encode(self, candidate) -> str:
        return str(candidate)

    def decode(self, raw: str):
        return raw

    def key(self, params: dict) -> str:
        return _cache.make_key(self.id, self.bucket(params),
                               str(params.get("dtype", "float32")),
                               device_kind(), versions())


_CHOICES: Dict[str, TunableChoice] = {}


def register_choice(choice: TunableChoice) -> TunableChoice:
    if not choice.id:
        raise ValueError("TunableChoice needs a non-empty id")
    if choice.id in _CHOICES:
        raise ValueError(f"duplicate tunable choice id {choice.id!r}")
    _CHOICES[choice.id] = choice
    return choice


def get_choice(choice_id: str) -> TunableChoice:
    try:
        return _CHOICES[choice_id]
    except KeyError:
        raise KeyError(
            f"unknown tunable choice {choice_id!r}; registered: "
            f"{sorted(_CHOICES)}") from None


def list_choices() -> List[str]:
    return sorted(_CHOICES)


def _count(choice_id: str, source: str):
    _OBS.counter("autotune_decisions_total",
                 "autotune decide() answers by choice point and source",
                 choice=choice_id, source=source).inc()


def _capturing() -> bool:
    import torch
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def decide(choice_id: str, params: dict, allow_search: bool = True,
           mode: Optional[str] = None):
    """Answer one tunable choice for ``params``.

    ``mode`` overrides the ``PADDLE_TPU_TUNE`` env gate (the CLI forces
    ``search``). ``allow_search=False`` never measures even in search mode.
    The answer is always a legal candidate: a stale persisted decision that
    is no longer in ``candidates(params)`` answers with the default. A
    search that would have to run while the current stream is capturing a
    CUDA graph raises: the decision belongs to the eager run before the
    capture, which the executor and the Predictor make first.
    """
    choice = get_choice(choice_id)
    m = mode if mode is not None else _cache.mode()
    if m == "off":
        return choice.default(params)
    key = choice.key(params)
    rec = _cache.CACHE.get(key)
    if rec is not None:
        try:
            val = choice.decode(rec["winner"])
        except (KeyError, ValueError, TypeError):
            val = None
        if val is not None and val in choice.candidates(params):
            _count(choice_id, "cached")
            return val
    if m == "search" and allow_search:
        if _capturing():
            raise RuntimeError(
                f"autotune: {choice_id} has no decision for {key} and the stream is "
                f"capturing a CUDA graph; decide in an eager run first (the executor's "
                f"and the Predictor's warm-up runs do)")
        rec = _measure.search(choice, params, key)
        _cache.CACHE.put(key, rec)
        _count(choice_id, "search")
        val = choice.decode(rec["winner"])
        if val in choice.candidates(params):
            return val
    _count(choice_id, "default")
    return choice.default(params)


# --------------------------------------------------------------------------------------
# choice point 1: the K2 kernel vs the unfused chain for the 1x1-conv+BN op
# --------------------------------------------------------------------------------------


class ConvBnBackend(TunableChoice):
    id = "conv2d_bn_fused.backend"
    doc = ("backend for the train-mode 1x1-conv+BN op: 'kernel' (the K2 CUDA "
           "kernel, statistics in its epilogue; its plain version on the CPU) "
           "or, on the CPU only, 'unfused' (torch.matmul, then the column sums "
           "in f32)")

    def bucket(self, params):
        # M = B*H*W scales with batch: bucket it; K/N are architectural
        return {"m": pow2_bucket(params["m"]), "k": int(params["k"]),
                "n": int(params["n"])}

    def candidates(self, params):
        # on the card the kernel alone (a shape it refuses raises in its wrapper)
        return ["kernel"] if on_card() else ["unfused", "kernel"]

    def default(self, params):
        return "kernel"   # the port before the autotuner

    def bench(self, params, candidate):
        import torch
        from ..ops import conv_bn
        m, k, n = (int(params[x]) for x in ("m", "k", "n"))
        dt = params.get("dtype", "float32")
        x2, w2 = _zeros((m, k), dt), _zeros((k, n), dt)
        vec = torch.zeros((k,), dtype=torch.float32, device=x2.device)
        one = torch.ones((k,), dtype=torch.float32, device=x2.device)
        if candidate == "kernel":
            def kernel_fn(x2, w2):
                return conv_bn.fused_conv1x1_bn_fwd(x2, w2, vec, one, vec, vec, 1e-5,
                                                    False, False)
            return kernel_fn, (x2, w2)

        def unfused_fn(x2, w2):
            return conv_bn.unfused_conv1x1_stats(x2, w2)
        return unfused_fn, (x2, w2)


# --------------------------------------------------------------------------------------
# choice point 2: the K1 kernels vs the composed attention at fused_attention's auto impl
# --------------------------------------------------------------------------------------


def _attn_bucket(params):
    """Shared shape bucket for BOTH attention choice points: bias/causal/
    dropout change the kernel's per-block work, so neither a backend verdict
    nor a tile measured under one configuration may be reused for another."""
    return {"bh": pow2_bucket(int(params["b"]) * int(params["h"])),
            "s": int(params["s"]), "d": int(params["d"]),
            "bias": bool(params.get("has_bias")),
            "causal": bool(params.get("causal")),
            "dropout": round(float(params.get("dropout", 0.0)), 3)}


def _attn_takes(params) -> bool:
    """Whether the K1 kernels take these shapes (``kernel_refusal``'s shape
    and dtype rules; strides and alignment are the tensors' own)."""
    from ..ops import flash_attention as fa
    return (int(params["d"]) in fa.HEAD_DIMS
            and int(params["b"]) * int(params["h"]) <= fa._MAX_BH
            and str(params.get("dtype", "float32")) in ("float32", "bfloat16"))


def _attn_inputs(params):
    b, h, s, d = (int(params[k]) for k in ("b", "h", "s", "d"))
    dt = params.get("dtype", "float32")
    q = _zeros((b, h, s, d), dt)
    bias = _zeros((b, 1, 1, s), dt) if params.get("has_bias") else None
    return q, bias


def _attn_scale(params) -> float:
    import math
    return float(params.get("scale") or 1.0 / math.sqrt(int(params["d"])))


class FlashBackend(TunableChoice):
    id = "fused_attention.backend"
    doc = ("impl='auto' backend for fused_attention: 'kernel' (the K1 CUDA "
           "kernels) or, on the CPU only, 'composed' (attention_plain: "
           "PyTorch matmuls and softmax)")

    def bucket(self, params):
        return _attn_bucket(params)

    def candidates(self, params):
        if not _attn_takes(params):
            return ["composed"]
        return ["kernel"] if on_card() else ["composed", "kernel"]

    def default(self, params):
        # the port before the autotuner: the kernels wherever they take the call
        return "kernel" if "kernel" in self.candidates(params) else "composed"

    def bench(self, params, candidate):
        from ..ops import flash_attention as fa
        q, bias = _attn_inputs(params)
        scale, dropout = _attn_scale(params), float(params.get("dropout", 0.0))
        causal = bool(params.get("causal"))
        if candidate == "kernel":
            def kernel_fn(q, k, v):
                return fa.flash_attn_fwd(q, k, v, bias, scale, causal, dropout, 0)
            return kernel_fn, (q, q, q)

        def composed_fn(q, k, v):
            return fa.attention_plain(q, k, v, bias, scale, causal, dropout, 0)
        return composed_fn, (q, q, q)


# --------------------------------------------------------------------------------------
# choice point 3: K1-fwd's query tile
# --------------------------------------------------------------------------------------


class FlashBlockSizes(TunableChoice):
    id = "fused_attention.block_sizes"
    doc = ("(query rows, keys) a block of the K1 forward kernel: the bf16 "
           "kernel is instantiated at 128 and 64 query rows (kMT 2 and 1 in "
           "csrc/flash_attn_fwd.cu), keys stream in 64-key tiles; the f32 "
           "kernel has one tile")

    #: keys a staged K/V tile (``kBN`` in csrc/flash_attn_fwd.cu)
    BLOCK_K = 64

    def bucket(self, params):
        return _attn_bucket(params)

    def candidates(self, params):
        from ..ops import flash_attention as fa
        if str(params.get("dtype", "float32")) != "bfloat16":
            return [(fa.FWD_BLOCK_Q[0], self.BLOCK_K)]
        return [(bq, self.BLOCK_K) for bq in fa.FWD_BLOCK_Q]

    def default(self, params):
        from ..ops import flash_attention as fa
        return (fa.FWD_BLOCK_Q[0], self.BLOCK_K)   # 128 rows: the tile before the autotuner

    def encode(self, candidate):
        return f"{int(candidate[0])},{int(candidate[1])}"

    def decode(self, raw):
        bq, bk = str(raw).split(",")
        return (int(bq), int(bk))

    def bench(self, params, candidate):
        from ..ops import flash_attention as fa
        q, bias = _attn_inputs(params)
        scale, dropout = _attn_scale(params), float(params.get("dropout", 0.0))
        causal, bq = bool(params.get("causal")), int(candidate[0])

        def fn(q, k, v):
            return fa.flash_attn_fwd(q, k, v, bias, scale, causal, dropout, 0, block_q=bq)
        return fn, (q, q, q)


# --------------------------------------------------------------------------------------
# choice point 4: conv2d compute layout (NHWC vs NCHW)
# --------------------------------------------------------------------------------------


class ConvLayout(TunableChoice):
    id = "conv2d.layout"
    doc = ("memory layout cuDNN computes a conv in, independent of the "
           "declared data_format: 'NHWC' (torch.channels_last) or 'NCHW' "
           "(contiguous). A decision differing from the declared format "
           "copies the activations and the filter at the op boundary.")

    def bucket(self, params):
        x = list(int(v) for v in params["x_shape"])
        x[0] = pow2_bucket(x[0])  # batch dim, both layouts
        return {"x": x, "w": [int(v) for v in params["w_shape"]],
                "s": [int(v) for v in params["strides"]],
                "p": [int(v) for v in params["pads"]],
                "d": [int(v) for v in params["dils"]],
                "g": int(params["groups"]), "fmt": params["fmt"]}

    def candidates(self, params):
        return ["NCHW", "NHWC"]

    def default(self, params):
        return params["fmt"]  # the port before the autotuner: run as declared

    def bench(self, params, candidate):
        from ..ops.nn_ops import conv_in_layout
        dt = params.get("dtype", "float32")
        x = _zeros(params["x_shape"], dt)
        w = _zeros(params["w_shape"], dt)
        strides = tuple(int(v) for v in params["strides"])
        pads = [int(v) for v in params["pads"]]
        dils = tuple(int(v) for v in params["dils"])
        groups = int(params["groups"])
        fmt = params["fmt"]

        def fn(x, w):
            return conv_in_layout(x, w, strides, pads, dils, groups, fmt, candidate)
        return fn, (x, w)


# --------------------------------------------------------------------------------------
# choice point 5: fused multi-step K (train_from_dataset's run_fused size)
# --------------------------------------------------------------------------------------


class FuseSteps(TunableChoice):
    id = "fuse_steps.k"
    doc = ("number of training steps one run_fused call takes in "
           "Executor.train_from_dataset(fuse_steps=0): K replays of the "
           "step's CUDA graph a call, with the K feeds stacked by the "
           "prefetch thread. Default 1 = the unfused loop. The candidates "
           "are NOT measurable in isolation (the payoff is the live "
           "workload's host overhead): the executor measures them in the "
           "loop and persists the winner via record_decision().")

    K_CANDIDATES = (1, 2, 4, 8, 16, 32)

    def bucket(self, params):
        # the amortization depends on the per-step feed signature (shapes +
        # dtypes drive the copies and the launches) and the fetch count
        return {"feed": params["feed"],
                "fetches": int(params.get("fetches", 0))}

    def candidates(self, params):
        return list(self.K_CANDIDATES)

    def default(self, params):
        return 1  # the unfused loop

    def bench(self, params, candidate):
        return None  # measured in the loop by train_from_dataset, never here

    def encode(self, candidate) -> str:
        return str(int(candidate))

    def decode(self, raw):
        return int(raw)


register_choice(ConvBnBackend())
register_choice(FlashBackend())
register_choice(FlashBlockSizes())
register_choice(ConvLayout())
register_choice(FuseSteps())


# --------------------------------------------------------------------------------------
# per-tensor gradient-allreduce compression (comm layer)
# --------------------------------------------------------------------------------------


class CommCompress(TunableChoice):
    id = "comm.compress"
    doc = ("per-tensor on/off for the compressed dp gradient allreduce "
           "(DistributedStrategy.comm_compression): 'on' quantizes this "
           "tensor (bf16/int8 + error feedback), 'off' keeps it full width. "
           "Tensors under the min_bytes floor have no 'on' candidate. The "
           "payoff is measured on the live step, never in isolation: "
           "external measurements persist via tuning.record_decision().")

    def bucket(self, params):
        return {"nbytes": pow2_bucket(int(params["nbytes"])),
                "world": int(params["world"]),
                "mode": str(params["mode"])}

    def candidates(self, params):
        floor = int(params.get("min_bytes", 0))
        if int(params["nbytes"]) < floor or int(params["world"]) <= 1:
            return ["off"]
        return ["off", "on"]

    def default(self, params):
        # the knob was set deliberately and the floor already excludes the
        # small tensors: compress everything the hard gates allow
        return "on" if "on" in self.candidates(params) else "off"

    def bench(self, params, candidate):
        return None   # measured on the live workload, never isolated


register_choice(CommCompress())
