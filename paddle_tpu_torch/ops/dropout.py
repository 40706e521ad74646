"""Dropout on a hand-written CUDA kernel (``csrc/dropout.cu``) and its plain
PyTorch version.

The port's counterpart of the draw inside the JAX dropout lowering
(``jax.random.bernoulli`` in the compiled step). The keep bits come from
Philox4x32-10, the generator of the flash-attention kernels
(``csrc/philox.cuh``), keyed by the op's 64-bit dropout seed: element ``i``
of X (row-major) takes word ``i % 4`` of the call with counter ``(g mod 2^32,
g >> 32, 0, 0)``, ``g = i // 4``, and is kept when that word is >= ``uint32(p
* 2^32)``. The seed is ``LowerCtx.kernel_seed``: inside an executor on the
card a ``DeviceSeed`` that the kernel derives from the run counter on the
card, so a CUDA graph of a training step draws new masks at every replay;
otherwise the host integer ``seed_int``. ``keep_mask`` computes the same bits
with integer tensor arithmetic (``philox4x32_10``, shared with the attention
kernels' plain versions), so the plain version drops exactly the kernel's
elements. The two RNGs of the packages differ (threefry vs Philox): the port
is held against the JAX package by statistics.

Out and Mask (in X's dtype) are computed in f32 and rounded once:
``downgrade_in_infer`` Out = X * Mask, ``upscale_in_train`` Out = (X * Mask)
/ (1 - p), all zeros when p = 1. The gradient (``Dropout``) is dOut * Mask,
divided by (1 - p) when upscaling.

Routing is by the device of the tensors: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel, or raises where it refuses the
call. Nothing falls back.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core import cuda_build
from .flash_attention import dropout_threshold, philox4x32_10, philox_key, seed_args

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_U32 = 0xFFFFFFFF
#: threads a block; blocks an SM at most (the grid strides over the rest)
THREADS, BLOCKS_PER_SM = 256, 8
#: elements a thread takes at a time (two generator calls)
GROUP = 8


def keep_mask(seed, n: int, p: float, device=None) -> torch.Tensor:
    """The kernel's keep mask of ``n`` elements, bool, for ``seed`` (an int
    or a ``DeviceSeed``)."""
    g = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(g)
    words = philox4x32_10(g & _U32, g >> 32, zero, zero, *philox_key(seed))
    bits = torch.stack(words, dim=-1).reshape(-1)[:n]
    return bits >= dropout_threshold(p)


def _out(x, mask, p: float, upscale: bool):
    """Out from X and the f32 mask, in f32, rounded once to X's dtype."""
    if upscale and p >= 1.0:
        return torch.zeros_like(x)
    y = x.float() * mask
    if upscale:
        # a 0-dim tensor on y's device: a true division (PyTorch turns the
        # division by a host scalar into a product with its reciprocal)
        y = y / torch.full((), 1.0 - p, dtype=torch.float32, device=y.device)
    return y.to(x.dtype)


def dropout_plain(x, p: float, upscale: bool, seed):
    """(Out, Mask) of dropout on ``x``, as the kernel computes them."""
    mask = keep_mask(seed, x.numel(), p, x.device).view(x.shape).float()
    return _out(x, mask, p, upscale), mask.to(x.dtype)


def kernel_refusal(x) -> Optional[str]:
    """Why the kernel cannot take ``x``, or None when it can."""
    if not x.is_cuda:
        return f"x must lie on a CUDA device, got {x.device}"
    if x.dtype not in _DTYPE_CODES:
        return f"x must be float32 or bfloat16, got {x.dtype}"
    if x.numel() == 0:
        return "x is empty"
    return None


def _check_p(p):
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout_prob must lie in [0, 1], got {p}")


_P, _U64 = ctypes.c_void_p, ctypes.c_ulonglong


def _fn():
    fn = cuda_build.load("dropout").dropout_fwd
    if fn.argtypes is None:
        # x out mask, n, dtype, threshold, 1 - p, upscale, seed counter program_seed salt,
        # grid, stream
        fn.argtypes = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _U64, ctypes.c_float,
                       ctypes.c_int, _U64, _P, _U64, _U64, ctypes.c_int, _P]
        fn.restype = ctypes.c_int
    return fn


@cuda_build.counted
def dropout_fwd(x, p: float, upscale: bool, seed):
    """Launch the dropout kernel on a CUDA tensor; returns (Out, Mask), new
    contiguous tensors in x's dtype. ``seed`` is an int or a ``DeviceSeed``
    on x's device. Raises ValueError for a tensor the kernel does not take
    and RuntimeError if the launch fails. Each launch adds one to
    ``dropout_fwd.launches``."""
    why = kernel_refusal(x)
    if why is not None:
        raise ValueError(f"dropout_fwd: {why}")
    _check_p(p)
    x = x.contiguous()
    out, mask = torch.empty_like(x), torch.empty_like(x)
    n = x.numel()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid = max(1, min(-(-n // (GROUP * THREADS)), sms * BLOCKS_PER_SM))
    with torch.cuda.device(x.device):
        rc = _fn()(x.data_ptr(), out.data_ptr(), mask.data_ptr(), n, _DTYPE_CODES[x.dtype],
                   dropout_threshold(p), 1.0 - p, int(bool(upscale)),
                   *seed_args(seed, x.device), grid, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dropout_fwd: kernel launch failed with CUDA error {rc}")
    dropout_fwd.launches += 1
    return out, mask


class Dropout(torch.autograd.Function):
    """Dropout on the kernel with a gradient: the forward launches the kernel
    and saves Mask; the backward is dOut * Mask (/ (1 - p) when
    upscaling), in f32, rounded to X's dtype. That backward is plain
    PyTorch and linear in dOut, so under ``create_graph`` it is
    differentiable again: a second-order gradient through dropout is the
    same product with the same mask, as the JAX lowering's."""

    @staticmethod
    def forward(ctx, x, p, upscale, seed):
        out, mask = dropout_fwd(x, p, upscale, seed)
        ctx.save_for_backward(mask)
        ctx.p, ctx.upscale = p, upscale
        ctx.mark_non_differentiable(mask)
        return out, mask

    @staticmethod
    def backward(ctx, dout, _dmask):
        mask, = ctx.saved_tensors
        return _out(dout, mask.float(), ctx.p, ctx.upscale), None, None, None


def dropout(x, p: float, upscale: bool, seed):
    """(Out, Mask) of train-mode dropout: the plain version for a CPU
    tensor, the kernel (with its gradient under autograd) for a CUDA one."""
    _check_p(p)
    if x.device.type == "cpu":
        return dropout_plain(x, p, upscale, seed)
    if torch.is_grad_enabled() and x.requires_grad:
        return Dropout.apply(x, p, upscale, seed)
    return dropout_fwd(x, p, upscale, seed)
