"""The ``fused_attention`` op: a hand-written CUDA flash-attention kernel and
its plain PyTorch version.

The port's counterpart of ``paddle_tpu/ops/pallas_attention.py``. The kernel
(``csrc/flash_attn_fwd.cu``) replaces the Pallas forward kernel
``_flash_fwd_impl`` / ``_fwd_kernel``; ``attention_plain`` transcribes
``composed_attention``.

Routing is by the device of the tensors: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel, or raises where the kernel's gate
refuses the call. Nothing falls back. ``impl='composed'`` asks for the plain
version explicitly; ``'auto'`` and ``'pallas'`` both mean the kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..core import cuda_build
from ..core.registry import register

#: head widths the kernel is compiled for (csrc/flash_attn_fwd.cu ``launch<D>``)
HEAD_DIMS = (32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BH = 65535  # grid.y


def attention_plain(q, k, v, bias=None, scale=None, causal=False, dropout=0.0,
                    generator=None):
    """softmax(Q K^T * scale + bias [, causal]) [* dropout] V, written out.

    A transcription of ``composed_attention``: scores in f32, bias widened
    to f32, causal mask -1e30, softmax in f32, P rounded to V's dtype before
    P V (accumulated in f32), output in Q's dtype. ``dropout`` > 0 draws the
    keep mask from ``generator``.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        S_q, S_k = s.shape[-2], s.shape[-1]
        keep = torch.ones((S_q, S_k), dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, -1e30)
    p = torch.softmax(s, dim=-1)
    if dropout:
        keep = torch.rand(p.shape, generator=generator, device=p.device) >= dropout
        p = torch.where(keep, p / (1.0 - dropout), torch.zeros((), device=p.device))
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def kernel_refusal(q, k, v, bias=None) -> Optional[str]:
    """Why the kernel cannot take these tensors, or None when it can."""
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


def _lib():
    lib = cuda_build.load("flash_attn_fwd")
    fn = lib.flash_attn_fwd
    if fn.argtypes is None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [ptr] * 5 + [i64] * 9 + [i32] * 4 + [ctypes.c_float] + [i32] * 3 + [ptr]
        fn.restype = ctypes.c_int
    return fn


def flash_attn_fwd(q, k, v, bias=None, scale=None, causal=False):
    """Launch the CUDA flash-attention forward kernel; returns O [B,H,S,D]
    (contiguous, in q's dtype). Raises ValueError for tensors the kernel does
    not take (see ``kernel_refusal``) and RuntimeError if the launch fails.
    Each launch adds one to ``flash_attn_fwd.launches``."""
    why = kernel_refusal(q, k, v, bias)
    if why is not None:
        raise ValueError(f"flash_attn_fwd: {why}")
    B, H, S, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    fn = _lib()
    o = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                bias.data_ptr() if bias is not None else None, o.data_ptr(),
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                B, H, S, D, float(scale), int(bool(causal)), int(bias is not None),
                _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attn_fwd: kernel launch failed with CUDA error {rc}")
    flash_attn_fwd.launches += 1
    return o


flash_attn_fwd.launches = 0


@register("fused_attention")
def fused_attention(ctx, ins):
    """softmax(Q K^T * scale + Bias) V over Q/K/V [B, heads, S, D] and an
    optional [B, 1, 1, S] additive Bias. Attrs: scale (0 = 1/sqrt(D)),
    dropout_prob, causal, is_test, impl ('auto' | 'pallas' | 'composed';
    'ring' and 'ulysses' are not ported)."""
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    bias = ins.get("Bias", [None])[0]
    scale = ctx.attr("scale") or (1.0 / math.sqrt(q.shape[-1]))
    dropout = 0.0 if ctx.attr("is_test", False) else ctx.attr("dropout_prob", 0.0)
    causal = bool(ctx.attr("causal", False))
    impl = ctx.attr("impl", "auto")
    if ctx.abstract:
        # shape inference on meta tensors: every impl has the plain version's shape
        return {"Out": [attention_plain(q, k, v, bias, float(scale), causal)]}
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"fused_attention impl={impl!r} (sequence parallelism) is not ported yet")
    if impl not in ("auto", "pallas", "composed"):
        raise ValueError(f"fused_attention: unknown impl {impl!r}")
    if q.device.type == "cpu" or impl == "composed":
        return {"Out": [attention_plain(q, k, v, bias, float(scale), causal, float(dropout),
                                        ctx.rng() if dropout else None)]}
    if dropout:
        raise NotImplementedError(
            "fused_attention with dropout > 0 on CUDA: the kernel has no dropout "
            "until the training slice")
    return {"Out": [flash_attn_fwd(q, k, v, bias, float(scale), causal)]}
