"""Dynamic int8 matmul: the hand-written CUDA kernel (``csrc/int8_matmul.cu``)
and its plain PyTorch version.

The port's counterpart of ``paddle_tpu/ops/pallas_int8.py``: the kernel
replaces ``fused_int8_matmul`` / ``_kernel``. Per-row activation scales
``xs = max(max|x| / 127, 1e-12)``, codes ``clip(round(x / xs), -127, 127)``
(round half to even), an int8 x int8 -> int32 product and the rescale
``(acc * xs) * wscale`` in that association (``_kernel``'s), rounded to
x's dtype. Every step is exactly rounded, so the kernel is held bit for bit
against ``int8_matmul_plain``.

Routing is by the device of the tensors: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel, or raises where the kernel
refuses the call. Nothing falls back.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROW_TILES = 65535  # grid.y of the smallest tiles' 64 rows


def row_scales(x2: torch.Tensor) -> torch.Tensor:
    """max(max_k |x| / 127, 1e-12) per row, [M, 1] f32. The divisor is a
    tensor: PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal, which is not the IEEE quotient the kernel and JAX take."""
    amax = x2.float().abs().amax(dim=1, keepdim=True)
    return torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-12)


def quantize_rows(x2: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """int8 codes clip(round(x / xs), -127, 127), round half to even."""
    return torch.clamp(torch.round(x2.float() / xs), -127, 127).to(torch.int8)


def int8_matmul_plain(x2, w8, wscale, return_codes=False):
    """The kernel's arithmetic step by step: x2 [M, K] f32/bf16, w8 [K, N]
    int8, wscale [N] (widened to f32) -> [M, N] in x2's dtype. The integer
    product is int32 on the CPU and float64 on the card (PyTorch has no CUDA
    integer matmul; |acc| <= 127^2 K < 2^53, so float64 is exact where
    float32, past 2^24, is not). ``return_codes`` also returns xs [M] and the
    codes [M, K]."""
    xs = row_scales(x2)
    xq = quantize_rows(x2, xs)
    if xq.is_cuda:
        acc = torch.matmul(xq.double(), w8.double())
    else:
        acc = torch.matmul(xq.int(), w8.int())
    out = ((acc.float() * xs) * wscale.float()).to(x2.dtype)
    return (out, xs.reshape(-1), xq) if return_codes else out


def kernel_refusal(x2, w8, wscale) -> Optional[str]:
    """Why the kernel cannot take these tensors, or None when it can."""
    if x2.ndim != 2 or w8.ndim != 2 or x2.shape[1] != w8.shape[0]:
        return f"x2 must be [M, K] and w8 [K, N], got {tuple(x2.shape)} / {tuple(w8.shape)}"
    M, K = x2.shape
    N = w8.shape[1]
    if x2.dtype not in _DTYPE_CODES:
        return f"x2 must be float32 or bfloat16, got {x2.dtype}"
    if w8.dtype != torch.int8:
        return f"w8 must be int8, got {w8.dtype}"
    if tuple(wscale.shape) != (N,) or wscale.dtype != torch.float32:
        return f"wscale must be float32 [{N}], got {wscale.dtype} {tuple(wscale.shape)}"
    if not (x2.is_cuda and w8.device == x2.device and wscale.device == x2.device):
        return f"tensors must lie on one CUDA device, got {x2.device}/{w8.device}/{wscale.device}"
    if not (x2.is_contiguous() and w8.is_contiguous() and wscale.is_contiguous()):
        return "x2, w8 and wscale must be contiguous"
    if M == 0 or K == 0 or N == 0:
        return f"empty shape M={M} K={K} N={N}"
    if (M + 63) // 64 > _MAX_ROW_TILES:
        return f"M={M} exceeds {64 * _MAX_ROW_TILES} rows"
    return None


# The product's tiles (rows, columns); ``int8_tile`` picks one by shape. The
# kernel keeps two blocks of either on an SM.
TILES = ((128, 128), (64, 64))


def int8_tile(M: int, N: int, sms: int) -> int:
    """Index into TILES: 128 x 128 where its grid is at least two waves of
    two blocks an SM, else 64 x 64 (BERT-base's fc layers at 8 x 512 tokens
    take the first but at N 768, and at 8 x 128 tokens the second)."""
    bm, bn = TILES[0]
    return 0 if -(-M // bm) * -(-N // bn) >= 4 * sms else 1


def padded_k(K: int) -> int:
    """The row stride of the codes scratch: K rounded up to 16 bytes."""
    return -(-K // 16) * 16


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_P, _I32 = ctypes.c_void_p, ctypes.c_int


def _fn():
    fn = cuda_build.load("int8_matmul").int8_matmul
    if fn.argtypes is None:
        # x, w8, wscale, out, xs, xq, M K N Kp dtype vec_x vec_w tile, stream
        fn.argtypes = [_P] * 6 + [_I32] * 8 + [_P]
        fn.restype = ctypes.c_int
    return fn


def _launch(device, pointers, *ints):
    """One call of the C entry (the quantize pass and the product) on the
    current stream of ``device``; raises if the launch fails."""
    with torch.cuda.device(device):
        rc = _fn()(*pointers, *ints, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul: kernel launch failed with CUDA error {rc}")


@cuda_build.counted
def int8_matmul(x2, w8, wscale, return_codes=False):
    """x2 [M, K] f32/bf16, w8 [K, N] int8, wscale [N] -> [M, N] in x2's
    dtype. A CPU tensor takes ``int8_matmul_plain``; a CUDA tensor launches
    the CUDA kernels (a pass that writes the row scales and the codes once,
    then the int8 product), raising ValueError for tensors they do not take
    (see ``kernel_refusal``) and RuntimeError if the launch fails. Each call
    on the card adds one to ``int8_matmul.launches``. ``return_codes`` also
    returns the row scales [M] and the int8 codes [M, K] the kernel
    computed (a view of its codes scratch, whose rows are padded to
    ``padded_k(K)``)."""
    if x2.device.type == "cpu":
        return int8_matmul_plain(x2, w8, wscale, return_codes)
    return _on_card(x2, w8, wscale, return_codes)


def _on_card(x2, w8, wscale, return_codes):
    wscale = wscale.float().contiguous()
    why = kernel_refusal(x2, w8, wscale)
    if why is not None:
        raise ValueError(f"int8_matmul: {why}")
    M, K = x2.shape
    N = w8.shape[1]
    Kp = padded_k(K)
    dev = x2.device
    out = torch.empty((M, N), dtype=x2.dtype, device=dev)
    xs = torch.empty((M,), dtype=torch.float32, device=dev)
    xq = torch.empty((M, Kp), dtype=torch.int8, device=dev)
    vec_x = int((K * x2.element_size()) % 16 == 0 and x2.data_ptr() % 16 == 0)
    vec_w = int(N % 16 == 0 and w8.data_ptr() % 16 == 0)
    _launch(dev, (x2.data_ptr(), w8.data_ptr(), wscale.data_ptr(), out.data_ptr(),
                  xs.data_ptr(), xq.data_ptr()),
            M, K, N, Kp, _DTYPE_CODES[x2.dtype], vec_x, vec_w, int8_tile(M, N, _sm_count(dev)))
    cuda_build.launched(int8_matmul)
    return (out, xs, xq[:, :K]) if return_codes else out
