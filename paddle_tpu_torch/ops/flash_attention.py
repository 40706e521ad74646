"""The ``fused_attention`` op: hand-written CUDA flash-attention kernels
(forward and backward) and their plain PyTorch versions.

The port's counterpart of ``paddle_tpu/ops/pallas_attention.py``. The
kernels replace the Pallas kernels of the ``_flash`` custom VJP:
``csrc/flash_attn_fwd.cu`` replaces ``_flash_fwd_impl`` / ``_fwd_kernel``
and ``csrc/flash_attn_bwd.cu`` replaces ``_flash_bwd`` / ``_bwd_kernel``.
``FlashAttention`` (a ``torch.autograd.Function``) ties them together the
way ``_flash.defvjp`` does. ``attention_plain`` transcribes
``composed_attention`` and ``attention_bwd_plain`` the backward kernel.

Attention dropout draws its keep mask from Philox4x32-10 keyed by a 64-bit
seed (``csrc/philox.cuh``); ``philox_keep_mask`` computes the same bits with
integer tensor arithmetic, so the plain versions drop exactly the kernels'
elements. Inside an executor on the card the kernels take the seed as a
``registry.DeviceSeed`` and derive it from the run counter on the card, so a
CUDA graph of a training step draws fresh masks at every replay; the plain
versions take the same seed as the host integer ``LowerCtx.seed_int``. (The TPU kernel's bits cannot be reproduced: dropout is
held against the JAX package by its statistics.)

Routing is by the device of the tensors: a CPU tensor takes the plain
version; a CUDA tensor launches the kernels, or raises where a kernel's gate
refuses the call. Nothing falls back. Under a bound ``sp`` group larger than
1 (a ``CompiledProgram`` whose mesh has the axis), as in the JAX package's
op, ``'auto'`` and ``'ring'`` run ring attention over the sequence blocks
(``parallel/ring_attention.py``) and ``'ulysses'`` the head-scatter
all-to-all (``parallel/ulysses.py``), each on these kernels; ``'ring'`` or
``'ulysses'`` without such a group raises, naming the impl. ``impl='composed'`` asks for the plain
version explicitly; ``'pallas'`` means the kernels, and ``'auto'`` the
kernels at the autotuner's ``fused_attention.block_sizes`` query tile
(``tuning/choices.py``), 128 rows by default. The autotuner's
``fused_attention.backend`` has the kernels as its one candidate on the
card, so the op does not ask it.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..core import cuda_build
from ..core.registry import DeviceSeed, register

#: head widths the kernels are compiled for (``launch<D>`` in csrc/flash_attn_*.cu)
HEAD_DIMS = (32, 64)
#: the bf16 forward's query rows a block, the default first: 128 (``kMT`` 2 in
#: csrc/flash_attn_fwd.cu) and 64 (``kMT`` 1); ``fused_attention.block_sizes``
#: picks between them. The f32 forward has one tile.
FWD_BLOCK_Q = (128, 64)
#: the longest S the fused bf16 backward takes: one block holds all keys
#: (``kKeys`` in csrc/flash_attn_bwd.cu)
BWD_FUSED_MAX_S = 128
#: the backward's variants, as csrc/flash_attn_bwd.cu numbers them
BWD_VARIANTS = {"f32": 0, "fused": 1, "split": 2}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BH = 65535  # grid.y

# Philox4x32-10 constants (csrc/philox.cuh)
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of m * x for a 32-bit constant m and int64 x in
    [0, 2^32). The 64-bit product overflows int64, so x is split into 16-bit
    halves: every partial product stays below 2^49."""
    a = m * (x & 0xFFFF)
    b = m * (x >> 16)
    t = ((b & 0xFFFF) << 16) + a
    return (b >> 16) + (t >> 32), t & _U32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding 32-bit words, as csrc/philox.cuh."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
    return c0, c1, c2, c3


def _xorshift(hi, lo, k: int):
    """(hi, lo) ^ ((hi, lo) >> k) on 32-bit words, 0 < k < 32."""
    return hi ^ (hi >> k), lo ^ (((lo >> k) | (hi << (32 - k))) & _U32)


def _mul64(hi, lo, c: int):
    """(hi, lo) * c mod 2^64 on 32-bit words, c a 64-bit constant."""
    ch, cl = c >> 32, c & _U32
    h0, l0 = _mulhilo(cl, lo)
    return (h0 + _mulhilo(cl, hi)[1] + _mulhilo(ch, lo)[1]) & _U32, l0


def _mix_words(h, v):
    """``registry._mix`` on 64-bit values held as (high, low) 32-bit words,
    ints or int64 tensors: every intermediate stays below 2^63."""
    hi, lo = h[0] ^ v[0], h[1] ^ v[1]
    lo = lo + (0x9E3779B97F4A7C15 & _U32)
    hi, lo = (hi + (0x9E3779B97F4A7C15 >> 32) + (lo >> 32)) & _U32, lo & _U32
    hi, lo = _mul64(*_xorshift(hi, lo, 30), 0xBF58476D1CE4E5B9)
    hi, lo = _mul64(*_xorshift(hi, lo, 27), 0x94D049BB133111EB)
    return _xorshift(hi, lo, 31)


def philox_key(seed):
    """The Philox key words (k0, k1) of a dropout seed: an int's low and high
    words; for a ``DeviceSeed``, ``seed_int``'s rounds over its counter,
    computed on the counter's device with integer tensor ops (no host read,
    so a CUDA graph can capture them), as ``run_seed`` does in the kernels."""
    if not isinstance(seed, DeviceSeed):
        seed &= 0xFFFFFFFFFFFFFFFF
        return seed & _U32, seed >> 32
    c = seed.counter.reshape(())
    s = seed.seed & 0xFFFFFFFFFFFFFFFF
    h = _mix_words((0, 0), (s >> 32, s & _U32))
    h = _mix_words(h, ((c >> 32) & _U32, c & _U32))
    hi, lo = _mix_words(h, (0, seed.salt & 0x7FFFFFFF))
    return lo, hi & 0x7FFFFFFF


def dropout_threshold(p: float) -> int:
    """Bits below this are dropped: uint32(p * 2^32), as the TPU kernel sets it."""
    return int(p * float(2 ** 32))


def philox_keep_mask(seed, B: int, H: int, S: int, p: float, device=None) -> torch.Tensor:
    """The kernels' attention-dropout keep mask, [B, H, S, S] bool, kept where
    the bits are >= the threshold. The bits of element (b, h, row, key) are
    word ``2 * ((row % 16) // 8) + key % 2`` of Philox4x32-10 with key = the
    64-bit seed and counter = ``(key // 2, (row // 16) * 8 + row % 8,
    b * H + h, 0)`` (csrc/philox.cuh): one call's four words are the four
    elements (rows r and r + 8, keys 2c and 2c + 1) that one thread holds in
    an m16n8 score fragment. A ragged S is a prefix of a wider one."""
    n2, n16 = (S + 1) // 2, (S + 15) // 16        # key pairs, 16-row groups
    shape = (B * H, n16 * 8, n2)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    c0 = ar(n2).view(1, 1, n2).expand(shape)
    c1 = ar(n16 * 8).view(1, n16 * 8, 1).expand(shape)
    c2 = ar(B * H).view(B * H, 1, 1).expand(shape)
    c3 = torch.zeros(shape, dtype=torch.int64, device=device)
    words = philox4x32_10(c0, c1, c2, c3, *philox_key(seed))
    # [bh, row // 16, row % 8, key // 2, (row % 16) // 8, key % 2] -> [bh, row, key]
    bits = torch.stack(words, dim=-1).view(B * H, n16, 8, n2, 2, 2)
    bits = bits.permute(0, 1, 4, 2, 3, 5).reshape(B, H, n16 * 16, n2 * 2)[:, :, :S, :S]
    return bits >= dropout_threshold(p)


def _logits(q, k, bias, scale, causal):
    """The f32 scores, as ``composed_attention`` computes them: bias
    widened to f32, causal mask -1e30."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        S_q, S_k = s.shape[-2], s.shape[-1]
        keep = torch.ones((S_q, S_k), dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, -1e30)
    return s


def _keep(q, dropout, seed):
    B, H, S, _ = q.shape
    return philox_keep_mask(seed, B, H, S, dropout, q.device)


def attention_plain(q, k, v, bias=None, scale=None, causal=False, dropout=0.0, seed=0,
                    return_lse=False):
    """dropout(softmax(Q K^T * scale + bias [, causal])) V, written out.

    A transcription of ``composed_attention``: scores in f32, bias widened
    to f32, causal mask -1e30, softmax in f32, P rounded to V's dtype before
    P V (accumulated in f32), output in Q's dtype. ``dropout`` > 0 drops with
    the kernels' Philox mask for ``seed``. With ``return_lse`` it returns
    (O, LSE) as the forward kernel does: the row log-sum-exp [B, H, S] f32
    of the pre-dropout scores (a ring block's, merged by the online-softmax
    rule).
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = _logits(q, k, bias, scale, causal)
    p = torch.softmax(s, dim=-1)
    if dropout:
        p = torch.where(_keep(q, dropout, seed), p / (1.0 - dropout),
                        torch.zeros((), device=p.device))
    o = torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)
    return (o, torch.logsumexp(s, dim=-1)) if return_lse else o


def attention_bwd_plain(q, k, v, bias, o, do, scale=None, causal=False, dropout=0.0,
                        seed=0, lse=None):
    """dQ, dK, dV of ``attention_plain``, written out for whole rows as
    ``_bwd_kernel`` computes them, in f32 on unrounded P: dV = Pd^T dO,
    dP = (dO V^T) * M, dS = P * (dP - D), dQ = dS K * scale, dK = dS^T Q *
    scale. D is rowsum(dO * O), as the kernel takes it (equal to the TPU
    kernel's rowsum(dP * P) up to the rounding of O). Given the row ``lse``
    (f32 [B, H, S]), P is exp(S - LSE), as the kernel takes it: a ring
    block's backward from the whole row's O and LSE. Returns them in q's,
    k's and v's dtypes; the bias gets no gradient."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = _logits(q, k, bias, scale, causal)
    p = torch.softmax(s, dim=-1) if lse is None else torch.exp(s - lse.unsqueeze(-1))
    dof = do.float()
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    pd = p
    if dropout:
        factor = _keep(q, dropout, seed).float() / (1.0 - dropout)
        pd = p * factor
        dp = dp * factor
    dv = torch.matmul(pd.transpose(-1, -2), dof)
    ds = p * (dp - (dof * o.float()).sum(-1, keepdim=True))
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def kernel_refusal(q, k, v, bias=None) -> Optional[str]:
    """Why the kernels cannot take these tensors, or None when they can."""
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        return f"q/k/v must share one [B,H,S,D] shape, got {q.shape}/{k.shape}/{v.shape}"
    B, H, S, D = q.shape
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        return (f"dtype must be float32 or bfloat16 on all of q/k/v, got "
                f"{q.dtype}/{k.dtype}/{v.dtype}")
    if D not in HEAD_DIMS:
        return f"head width D={D} is not one the kernel is compiled for {HEAD_DIMS}"
    if B * H > _MAX_BH:
        return f"B*H={B * H} exceeds {_MAX_BH}"
    if bias is not None:
        if tuple(bias.shape) != (B, 1, 1, S):
            return f"bias must be [B,1,1,S]=[{B},1,1,{S}], got {list(bias.shape)}"
        if bias.dtype != q.dtype or bias.device != q.device:
            return f"bias must match q's dtype and device, got {bias.dtype}/{bias.device}"
        if not bias.is_contiguous():
            return "bias must be contiguous"
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        return f"q/k/v must lie on one CUDA device, got {q.device}/{k.device}/{v.device}"
    align = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            return f"{name} must be contiguous along D (stride {t.stride()})"
        if t.data_ptr() % 16 or any(st % align for st in t.stride()[:3]):
            return f"{name} rows must be 16-byte aligned (strides {t.stride()})"
    return None


def bwd_refusal(q, k, v, bias, o, lse, do) -> Optional[str]:
    """Why the backward kernel cannot take these tensors, or None when it can."""
    why = kernel_refusal(q, k, v, bias)
    if why is not None:
        return why
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            return (f"{name} must match q's shape, dtype and device, got "
                    f"{tuple(t.shape)}/{t.dtype}/{t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            return f"{name} must be contiguous and 16-byte aligned"
    if (tuple(lse.shape) != tuple(q.shape[:3]) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        return (f"lse must be a contiguous float32 [B,H,S] on q's device, got "
                f"{tuple(lse.shape)}/{lse.dtype}/{lse.device}")
    return None


def _check_dropout(dropout):
    if not 0.0 <= dropout < 1.0:
        raise ValueError(f"dropout must lie in [0, 1), got {dropout}")


_P, _I64, _I32, _U64 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_ulonglong
# the dropout seed: by value, then (counter pointer, program seed, salt)
_SEED = [_U64, _P, _U64, _U64]
_SIGNATURES = {
    # pointers, 9 strides, B H S D, scale, causal has_bias dtype, dropout, threshold, seed,
    # block_q, stream
    "flash_attn_fwd": [_P] * 6 + [_I64] * 9 + [_I32] * 4 + [ctypes.c_float] + [_I32] * 3
    + [ctypes.c_float, ctypes.c_uint] + _SEED + [_I32, _P],
    "flash_attn_bwd": [_P] * 11 + [_I64] * 9 + [_I32] * 4 + [ctypes.c_float] + [_I32] * 3
    + [ctypes.c_float, ctypes.c_uint] + _SEED + [_I32, _P],  # ..., variant, stream
}


def seed_args(seed, device) -> tuple:
    """A kernel's dropout-seed arguments: (seed, counter pointer, program
    seed, salt). An int seed goes by value with a null counter; a
    ``DeviceSeed`` passes its counter, which must lie on ``device``."""
    if isinstance(seed, DeviceSeed):
        c = seed.counter
        if c.device != device or c.dtype != torch.int64 or c.numel() != 1:
            raise ValueError(f"the run counter must be one int64 element on {device}, got "
                             f"{c.dtype} {tuple(c.shape)} on {c.device}")
        return (0,) + seed.args()
    return (seed & 0xFFFFFFFFFFFFFFFF, None, 0, 0)


def _fn(name):
    fn = getattr(cuda_build.load(name), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def _launch(name, pointers, q, k, v, bias, scale, causal, dropout, seed, *extra):
    B, H, S, D = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _fn(name)(*pointers, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                       B, H, S, D, float(scale), int(bool(causal)), int(bias is not None),
                       _DTYPE_CODES[q.dtype], float(dropout), dropout_threshold(dropout),
                       *seed_args(seed, q.device), *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def _fwd(q, k, v, bias, scale, causal, dropout, seed, return_lse, block_q):
    why = kernel_refusal(q, k, v, bias)
    if why is not None:
        raise ValueError(f"flash_attn_fwd: {why}")
    _check_dropout(dropout)
    if block_q not in FWD_BLOCK_Q or (block_q != FWD_BLOCK_Q[0] and q.dtype != torch.bfloat16):
        raise ValueError(f"flash_attn_fwd: block_q={block_q} is not a tile of the "
                         f"{q.dtype} kernel (bf16: {FWD_BLOCK_Q}, f32: {FWD_BLOCK_Q[0]})")
    B, H, S, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    o = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if return_lse else None
    _launch("flash_attn_fwd",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(),
             bias.data_ptr() if bias is not None else None, o.data_ptr(),
             lse.data_ptr() if lse is not None else None),
            q, k, v, bias, scale, causal, dropout, seed, int(block_q))
    return (o, lse) if return_lse else o


@cuda_build.counted
def flash_attn_fwd(q, k, v, bias=None, scale=None, causal=False, dropout=0.0, seed=0,
                   return_lse=False, block_q=FWD_BLOCK_Q[0]):
    """Launch the CUDA flash-attention forward kernel; returns O [B,H,S,D]
    (contiguous, in q's dtype), and with ``return_lse`` also the row LSE
    [B,H,S] f32 that the backward needs. ``dropout`` > 0 drops attention
    probabilities with the Philox mask of ``seed`` (an int, or a
    ``DeviceSeed`` that the kernel reads from the run counter on the card).
    ``block_q`` is the bf16 kernel's query rows a block (``FWD_BLOCK_Q``);
    64 goes through ``flash_attn_fwd_q64``, which counts its own launches.
    Raises ValueError for tensors the kernel does not take (see
    ``kernel_refusal``) and RuntimeError if the launch fails. Each launch of
    the 128-row tile (and of the f32 kernel) adds one to
    ``flash_attn_fwd.launches``."""
    if block_q == 64:
        return flash_attn_fwd_q64(q, k, v, bias, scale, causal, dropout, seed, return_lse)
    out = _fwd(q, k, v, bias, scale, causal, dropout, seed, return_lse, block_q)
    cuda_build.launched(flash_attn_fwd)
    return out


@cuda_build.counted
def flash_attn_fwd_q64(q, k, v, bias=None, scale=None, causal=False, dropout=0.0, seed=0,
                       return_lse=False):
    """``flash_attn_fwd`` at the bf16 kernel's 64-row query tile (``kMT`` 1);
    each launch adds one to ``flash_attn_fwd_q64.launches``."""
    out = _fwd(q, k, v, bias, scale, causal, dropout, seed, return_lse, 64)
    cuda_build.launched(flash_attn_fwd_q64)
    return out


def bwd_variant(S: int, dtype: torch.dtype) -> str:
    """The backward kernels a call runs: ``'fused'`` (bf16, S <=
    ``BWD_FUSED_MAX_S``: one launch per call, one block per (batch, head)
    computing dQ, dK, dV and D), ``'split'`` (bf16, longer S: a dQ kernel
    that also writes D, then a dK/dV kernel) or ``'f32'`` (a D pre-pass and
    the two FMA kernels)."""
    if dtype == torch.float32:
        return "f32"
    return "fused" if S <= BWD_FUSED_MAX_S else "split"


@cuda_build.counted
def flash_attn_bwd(q, k, v, bias, o, lse, do, scale=None, causal=False, dropout=0.0,
                   seed=0):
    """Launch the CUDA flash-attention backward (the kernels of
    ``bwd_variant``); returns dq, dk, dv, contiguous, in the inputs' dtype.
    ``o`` and ``lse`` are the forward's, ``dropout`` and ``seed`` must be the
    forward's too. Raises ValueError for tensors the kernels do not take
    (see ``bwd_refusal``). Each call adds one to
    ``flash_attn_bwd.launches``."""
    why = bwd_refusal(q, k, v, bias, o, lse, do)
    if why is not None:
        raise ValueError(f"flash_attn_bwd: {why}")
    _check_dropout(dropout)
    B, H, S, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    variant = bwd_variant(S, q.dtype)
    delta = (None if variant == "fused"
             else torch.empty((B, H, S), dtype=torch.float32, device=q.device))
    dq, dk, dv = (torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    _launch("flash_attn_bwd",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(),
             bias.data_ptr() if bias is not None else None, o.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr() if delta is not None else None,
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            q, k, v, bias, scale, causal, dropout, seed, BWD_VARIANTS[variant])
    cuda_build.launched(flash_attn_bwd)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention on the CUDA kernels with a gradient: the forward launches
    the forward kernel (with the LSE) and saves (q, k, v, bias, O, LSE,
    seed); the backward launches the backward kernel. dq comes back in q's
    dtype, dk and dv (accumulated in f32) in k's and v's; the bias gets
    none.

    The backward kernel has no gradient of its own: a second-order gradient
    through it (``create_graph``) raises instead of returning tensors with
    no graph, which would count as zeros. The JAX package's Pallas kernel
    has none either (its ``pallas_call`` has no reverse-mode rule);
    ``impl="composed"`` is the plain attention, differentiable twice."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, causal, dropout, seed, block_q=FWD_BLOCK_Q[0]):
        o, lse = flash_attn_fwd(q, k, v, bias, scale, causal, dropout, seed,
                                return_lse=True, block_q=block_q)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.args = (scale, causal, dropout, seed)
        return o

    @staticmethod
    def backward(ctx, do):
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "a second-order gradient through fused_attention on the card needs a "
                "double-backward kernel of flash_attn_bwd, which is not written (ROADMAP "
                "queue 2a); use impl='composed' for a gradient of a gradient")
        q, k, v, bias, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attn_bwd(q, k, v, bias, o, lse, do.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def _sp_over_gloo(op):
    """Attention under a bound sp group over gloo is not captured: the
    ring's and Ulysses's calls are on the host."""
    from . import collective as _coll
    g = _coll.bound("sp")
    if g is not None and g.size > 1 and g.backend == "gloo":
        return "op 'fused_attention' rotates its blocks over gloo, whose calls are on the host"
    return None


def _sequence_parallel(ctx, q, k, v, bias, scale, dropout, causal, impl):
    """The op under a bound ``sp`` group larger than 1 (the JAX package's
    routing): ``'auto'`` / ``'ring'`` the ring, ``'ulysses'`` Ulysses. None
    when no such group is bound and the impl does not ask for one. Under
    the group each rank holds only its block of the positions, so every
    other case raises (``'pallas'``, ``'composed'``, a bias that is not
    [B,1,1,S]): attention within the block would be another function."""
    from . import collective as _coll
    g = _coll.bound("sp")
    sp_n = g.size if g is not None else 1
    if sp_n == 1:
        if impl in ("ring", "ulysses"):
            raise ValueError(
                f"fused_attention impl={impl!r} needs a bound sp group larger than 1 (a "
                f"CompiledProgram whose mesh has an sp axis); got sp={sp_n}")
        return None
    B, H, S, _ = q.shape
    if impl not in ("auto", "ring", "ulysses") \
            or (bias is not None and tuple(bias.shape) != (B, 1, 1, S)):
        raise ValueError(
            f"fused_attention under sp={sp_n} holds this rank's block of {S} positions and "
            f"attends over the whole sequence only through the ring (impl 'auto' or 'ring') "
            f"or Ulysses ('ulysses') with a [B,1,1,S] bias or none; got impl={impl!r}, "
            f"bias={None if bias is None else tuple(bias.shape)}")
    seed = ctx.kernel_seed() if dropout else 0
    if impl == "ulysses":
        from ..parallel import ulysses as _uly
        return _uly.ulysses_attention(q, k, v, bias, float(scale), float(dropout), causal,
                                      seed, g)
    from ..parallel import ring_attention as _ring
    return _ring.ring_attention(q, k, v, bias, float(scale), float(dropout), causal, seed, g)


@register("fused_attention", nondiff_inputs=("Bias",), capture_refusal=_sp_over_gloo)
def fused_attention(ctx, ins):
    """dropout(softmax(Q K^T * scale + Bias)) V over Q/K/V [B, heads, S, D]
    and an optional [B, 1, 1, S] additive Bias (no gradient). Attrs: scale
    (0 = 1/sqrt(D)), dropout_prob, causal, is_test, impl ('auto' | 'pallas'
    | 'ring' | 'ulysses' | 'composed'). Under a bound ``sp`` group larger
    than 1, 'auto' and 'ring' run ring attention and 'ulysses' Ulysses over
    this rank's sequence block (``_sequence_parallel``), and 'pallas',
    'composed' or another bias shape raise; 'ring' or 'ulysses' without
    one raises. Otherwise, on the card, 'auto'
    runs the kernels at the autotuner's ``fused_attention.block_sizes``
    query tile (128 rows by default) where they take the call; where they
    do not, the kernel raises as 'pallas' does. The dropout seed is
    the op's ``seed_int()``, which its grad op shares, so the backward
    regenerates the forward's mask; on the card, inside an executor, the
    kernels derive that seed from the run counter (``kernel_seed``)."""
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    bias = ins.get("Bias", [None])[0]
    scale = ctx.attr("scale") or (1.0 / math.sqrt(q.shape[-1]))
    dropout = 0.0 if ctx.attr("is_test", False) else ctx.attr("dropout_prob", 0.0)
    causal = bool(ctx.attr("causal", False))
    impl = ctx.attr("impl", "auto")
    if ctx.abstract:
        # shape inference on meta tensors: every impl has the plain version's shape
        return {"Out": [attention_plain(q, k, v, bias, float(scale), causal)]}
    if impl not in ("auto", "pallas", "ring", "ulysses", "composed"):
        raise ValueError(f"fused_attention: unknown impl {impl!r}")
    if bias is not None and bias.dtype != q.dtype \
            and torch.promote_types(bias.dtype, q.dtype) == q.dtype:
        # a narrower bias (a bf16 model's mask served in f32, Predictor.run(dtype=...)):
        # widened exactly, as the plain version's promotion does
        bias = bias.to(q.dtype)
    out = _sequence_parallel(ctx, q, k, v, bias, scale, dropout, causal, impl)
    if out is not None:
        return {"Out": [out]}
    seed = ctx.kernel_seed() if dropout else 0    # an int off the card
    block_q = FWD_BLOCK_Q[0]
    if impl == "auto" and q.device.type == "cuda" and kernel_refusal(q, k, v, bias) is None:
        from ..tuning import choices as _choices
        B, H, S, D = q.shape
        params = {"b": B, "h": H, "s": S, "d": D, "dtype": _choices.dtype_name(q),
                  "has_bias": bias is not None, "dropout": float(dropout),
                  "causal": causal, "scale": float(scale)}
        block_q = _choices.decide("fused_attention.block_sizes", params)[0]
    if q.device.type == "cpu" or impl == "composed":
        return {"Out": [attention_plain(q, k, v, bias, float(scale), causal, float(dropout),
                                        seed)]}
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        # kept for fused_attention_grad (or its recompute): the kernels'
        # autograd pair, whose forward launch also writes the LSE
        out = FlashAttention.apply(q, k, v, bias, float(scale), causal, float(dropout), seed,
                                   block_q)
    else:
        out = flash_attn_fwd(q, k, v, bias, float(scale), causal, float(dropout), seed,
                             block_q=block_q)
    return {"Out": [out]}
