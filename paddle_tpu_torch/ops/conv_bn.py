"""Fused 1x1 convolution + batch-norm statistics: the hand-written CUDA
kernel (``csrc/conv1x1_bn.cu``), its plain PyTorch version, the autograd
pair and the ``conv2d_bn_fused`` op.

The port's counterpart of ``paddle_tpu/ops/pallas_conv_bn.py``: the kernel
replaces ``fused_conv1x1_bn_fwd`` / ``_kernel``. It computes
``y = prologue(x2) @ w`` rounded to x2's dtype, with the prologue (the
previous batch norm's normalise, then relu, each optional) applied to x2 in
f32 and rounded to x2's dtype, and the per-column sum and sum of squares of
the rounded y in f32: the next batch norm's statistics without a pass over
y. ``FusedConv1x1BN`` gives it a gradient, the plain formulation of the
TPU kernel's custom VJP (``_bwd``), in which the cotangents of the
statistics flow back into y.

Routing is by the device of the tensors: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel, or raises where the kernel
refuses the call. Nothing falls back. No shape gate is copied from the TPU
kernel: on the card every ``conv2d_bn_fused`` in train mode launches it. On
the CPU the autotuner's ``conv2d_bn_fused.backend`` picks between the
kernel's plain version and the unfused chain (``unfused_conv1x1_stats``);
on the card that choice has the kernel as its one candidate.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core import cuda_build
from ..core.registry import register
from . import collective as _coll

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROW_TILES = 65535  # grid.y of the f32 kernel's 64-row tiles


def _prologue(x2, mu, var, gamma, beta, eps, relu_in, apply_in_bn):
    """relu((x - mu) * rsqrt(var + eps) * gamma + beta) in f32 (each part
    optional), as ``_kernel`` computes it; returns (z f32, inv or None)."""
    z = x2.float()
    inv = None
    if apply_in_bn:
        inv = torch.rsqrt(var.float() + eps)
        z = (z - mu.float()) * inv * gamma.float() + beta.float()
    if relu_in:
        z = torch.clamp_min(z, 0.0)
    return z, inv


def conv1x1_bn_plain(x2, w, mu, var, gamma, beta, eps=1e-5, relu_in=True,
                     apply_in_bn=True):
    """The kernel's arithmetic: x2 [M, K], w [K, N] -> (y [M, N] in x2's
    dtype, sum [N] f32, sum of squares [N] f32). The prologue in f32,
    rounded to x2's dtype; the product of the rounded values accumulated in
    f32 (an f32 matmul of the widened operands) and rounded to x2's dtype;
    the statistics of that rounded y."""
    z, _ = _prologue(x2, mu, var, gamma, beta, eps, relu_in, apply_in_bn)
    zb = z.to(x2.dtype)
    y = torch.matmul(zb.float(), w.float()).to(x2.dtype)
    yf = y.float()
    return y, yf.sum(dim=0), (yf * yf).sum(dim=0)


def unfused_conv1x1_stats(x2, w):
    """The unfused route of the train-mode op on the CPU
    (``conv2d_bn_fused.backend`` = ``unfused``; never a route on the card):
    y = x2 @ w by ``torch.matmul`` in x2's dtype, then the
    column sum and sum of squares of y in f32 by PyTorch reductions.
    Returns (y, sum, sum of squares) as the kernel does, differentiable."""
    y = torch.matmul(x2, w)
    yf = y.float()
    return y, yf.sum(dim=0), (yf * yf).sum(dim=0)


def kernel_refusal(x2, w) -> Optional[str]:
    """Why the kernel cannot take these tensors, or None when it can."""
    if x2.ndim != 2 or w.ndim != 2 or x2.shape[1] != w.shape[0]:
        return f"x2 must be [M, K] and w [K, N], got {tuple(x2.shape)} / {tuple(w.shape)}"
    M, K = x2.shape
    if x2.dtype not in _DTYPE_CODES or w.dtype != x2.dtype:
        return f"x2 and w must share float32 or bfloat16, got {x2.dtype} / {w.dtype}"
    if not (x2.is_cuda and w.device == x2.device):
        return f"x2 and w must lie on one CUDA device, got {x2.device} / {w.device}"
    if not x2.is_contiguous():
        return "x2 must be contiguous"
    if M == 0 or K == 0 or w.shape[1] == 0:
        return f"empty shape M={M} K={K} N={w.shape[1]}"
    if x2.dtype == torch.float32 and (M + 63) // 64 > _MAX_ROW_TILES:
        return f"M={M} exceeds {64 * _MAX_ROW_TILES} rows in float32"
    return None


# The bf16 kernel's tiles: 128 rows by 128 columns (64 where N <= 64). Its grid
# is persistent: block (cb, gy) of a (col_blocks, rows) grid owns column block cb
# and walks the M tiles gy, gy + rows, gy + 2 rows, ...; it writes row gy of the
# column partials, and the second kernel sums the rows in a fixed order.
BF16_TILE_M = 128


def bf16_tile_n(N: int) -> int:
    return 64 if N <= 64 else 128


def partial_rows(M: int, N: int, dtype, sms: int) -> int:
    """Rows of the f32 partial-sum scratch [2, rows, N], which is also the
    grid's y extent. bf16: about two blocks an SM over the column blocks,
    at most one per M tile. f32 (the first version's kernel): one per
    64-row tile."""
    if dtype == torch.float32:
        return -(-M // 64)
    tiles = -(-M // BF16_TILE_M)
    col_blocks = -(-N // bf16_tile_n(N))
    return max(1, min(tiles, -(-2 * sms // col_blocks)))


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_P, _I32 = ctypes.c_void_p, ctypes.c_int


def _fn():
    fn = cuda_build.load("conv1x1_bn").conv1x1_bn
    if fn.argtypes is None:
        # x, w^T, mu, inv, g, b, y, part, s, ss, M K N dtype apply relu vec rows, stream
        fn.argtypes = [_P] * 10 + [_I32] * 8 + [_P]
        fn.restype = ctypes.c_int
    return fn


def _launch(device, pointers, *ints):
    """One call of the C entry (the product and the column sums) on the
    current stream of ``device``; raises if the launch fails."""
    with torch.cuda.device(device):
        rc = _fn()(*pointers, *ints, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_conv1x1_bn_fwd: kernel launch failed with CUDA error {rc}")


@cuda_build.counted
def fused_conv1x1_bn_fwd(x2, w, mu, var, gamma, beta, eps=1e-5, relu_in=True,
                         apply_in_bn=True):
    """x2 [M, K], w [K, N], mu/var/gamma/beta [K] -> (y [M, N] in x2's
    dtype, sum [N] f32, sum of squares [N] f32). A CPU tensor takes
    ``conv1x1_bn_plain``; a CUDA tensor launches the CUDA kernel, raising
    ValueError for tensors it does not take (see ``kernel_refusal``) and
    RuntimeError if the launch fails. The kernel reads the filter as
    w^T = [N, K] row-major: the transposed view of a contiguous [N, K]
    filter costs no copy. Each launch adds one to
    ``fused_conv1x1_bn_fwd.launches``."""
    if x2.device.type == "cpu":
        return conv1x1_bn_plain(x2, w, mu, var, gamma, beta, eps, relu_in, apply_in_bn)
    return _on_card(x2, w, mu, var, gamma, beta, eps, relu_in, apply_in_bn)


def _on_card(x2, w, mu, var, gamma, beta, eps, relu_in, apply_in_bn):
    why = kernel_refusal(x2, w)
    if why is not None:
        raise ValueError(f"fused_conv1x1_bn_fwd: {why}")
    M, K = x2.shape
    N = w.shape[1]
    dev = x2.device
    wt = w.t().contiguous()
    vec = [p.float().contiguous() for p in (mu, var, gamma, beta)]
    if any(tuple(v.shape) != (K,) or v.device != dev for v in vec):
        raise ValueError(f"fused_conv1x1_bn_fwd: mu/var/gamma/beta must be [{K}] on {dev}")
    mu32, var32, g32, b32 = vec
    # outside the kernel, as the TPU path computes it; the op's path (no prologue)
    # reads none of the four vectors
    inv = torch.rsqrt(var32 + eps) if apply_in_bn else var32
    y = torch.empty((M, N), dtype=x2.dtype, device=dev)
    s = torch.empty((N,), dtype=torch.float32, device=dev)
    ss = torch.empty((N,), dtype=torch.float32, device=dev)
    rows = partial_rows(M, N, x2.dtype, _sm_count(dev))
    part = torch.empty((2, rows, N), dtype=torch.float32, device=dev)
    aligned = K % 8 == 0 and x2.data_ptr() % 16 == 0 and wt.data_ptr() % 16 == 0
    _launch(dev, (x2.data_ptr(), wt.data_ptr(), mu32.data_ptr(), inv.data_ptr(),
                  g32.data_ptr(), b32.data_ptr(), y.data_ptr(), part.data_ptr(),
                  s.data_ptr(), ss.data_ptr()),
            M, K, N, _DTYPE_CODES[x2.dtype], int(bool(apply_in_bn)), int(bool(relu_in)),
            int(aligned), rows)
    cuda_build.launched(fused_conv1x1_bn_fwd)
    return y, s, ss


def conv1x1_bn_bwd_plain(x2, w, mu, var, gamma, beta, y, dy, ds, dss, eps, relu_in,
                         apply_in_bn):
    """Input grads of the fused forward, transcribing ``_bwd``: the
    statistics' cotangents reach y elementwise (d sum / dy = 1, d sumsq /
    dy = 2y), dy_tot is rounded to x2's dtype, then dW = z^T dy_tot and
    dz = dy_tot W^T back through the prologue. The matmuls run in the
    operands' dtype (on the card bf16 with f32 accumulation, rounded once,
    as JAX rounds dW and, without the prologue, dx); mu and var get zero
    grads, as the TPU kernel's VJP gives them."""
    dy_tot = (dy.float() + ds.float()[None, :]
              + 2.0 * y.float() * dss.float()[None, :]).to(x2.dtype)
    z, inv = _prologue(x2, mu, var, gamma, beta, eps, relu_in, apply_in_bn)
    dw = torch.matmul(z.to(x2.dtype).t(), dy_tot).to(w.dtype)
    dz = torch.matmul(dy_tot, w.to(x2.dtype).t()).float()
    if relu_in:
        dz = torch.where(z > 0.0, dz, torch.zeros((), device=dz.device))
    if apply_in_bn:
        xf = x2.float()
        dgamma = (dz * (xf - mu.float()) * inv).sum(dim=0).to(gamma.dtype)
        dbeta = dz.sum(dim=0).to(beta.dtype)
        dx = (dz * inv * gamma.float()).to(x2.dtype)
    else:
        dgamma, dbeta = torch.zeros_like(gamma), torch.zeros_like(beta)
        dx = dz.to(x2.dtype)
    return dx, dw, torch.zeros_like(mu), torch.zeros_like(var), dgamma, dbeta


class FusedConv1x1BN(torch.autograd.Function):
    """``fused_conv1x1_bn_fwd`` with a gradient: the forward launches the
    kernel (or, on the CPU, its plain version) and saves its inputs and y;
    the backward is ``conv1x1_bn_bwd_plain``.

    A second-order gradient (``create_graph``) raises, on both devices: the
    saved y has no graph to x and w, so the backward's own gradient would
    miss every path through y. The JAX package raises there too (its
    custom vjp differentiates the Pallas forward, which has no rule)."""

    @staticmethod
    def forward(ctx, x2, w, mu, var, gamma, beta, eps, relu_in, apply_in_bn):
        y, s, ss = fused_conv1x1_bn_fwd(x2, w, mu, var, gamma, beta, eps, relu_in,
                                        apply_in_bn)
        ctx.save_for_backward(x2, w, mu, var, gamma, beta, y)
        ctx.args = (eps, relu_in, apply_in_bn)
        return y, s, ss

    @staticmethod
    def backward(ctx, dy, ds, dss):
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "a second-order gradient through conv2d_bn_fused needs the fused "
                "conv + batch-norm statistics to be differentiable twice, which they "
                "are not (as in the JAX package); run the unfused conv2d and "
                "batch_norm for a gradient of a gradient")
        x2, w, mu, var, gamma, beta, y = ctx.saved_tensors
        grads = conv1x1_bn_bwd_plain(x2, w, mu, var, gamma, beta, y, dy, ds, dss,
                                     *ctx.args)
        return (*grads, None, None, None)


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _infer_shape(op, block):
    x = block.find_var_recursive(op.inputs["Input"][0])
    w = block.find_var_recursive(op.inputs["Filter"][0])
    out_c = w.shape[0]
    block.create_var(op.outputs["Y"][0], list(x.shape[:-1]) + [out_c],
                     x.dtype).stop_gradient = False
    for slot in ("SavedMean", "SavedVariance"):
        for n in op.outputs.get(slot, []):
            block.create_var(n, [out_c], "float32").stop_gradient = True


@register("conv2d_bn_fused", nondiff_inputs=("Mean", "Variance"), infer_shape=_infer_shape,
          state_inputs=("Mean", "Variance"), capture_refusal=_coll.stats_capture_refusal,
          nondiff_outputs=("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"))
def conv2d_bn_fused(ctx, ins):
    """1x1/s1 NHWC conv + batch_norm (+ relu when ``act="relu"``) in one op,
    made by ``contrib.fuse_conv_bn_stats``. Train mode runs the conv as the
    fused kernel without its prologue, whose epilogue gives the batch
    statistics (mean = s / M, var = ss / M - mean^2 clamped at 0), then
    normalises, moves the running statistics by ``momentum`` and applies
    the activation. On a data-parallel run of more than one rank the sums
    are all-reduced over ``dp`` first (the global batch's statistics). On the CPU the autotuner's ``conv2d_bn_fused.backend``
    may pick the unfused route instead (``unfused_conv1x1_stats``); its
    default is the kernel's plain version, and on the card the kernel is its
    one candidate, so the op is not asked there. Test
    mode (``is_test`` or ``use_global_stats``) is the plain product
    normalised with the running statistics."""
    x, w = ins["Input"][0], ins["Filter"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean_in, var_in = ins["Mean"][0], ins["Variance"][0]
    eps = ctx.attr("epsilon", 1e-5)
    momentum = ctx.attr("momentum", 0.9)
    act = ctx.attr("act", None)
    if act not in (None, "relu"):
        raise NotImplementedError(f"conv2d_bn_fused: act={act!r}")
    B, H, W_, C = x.shape
    O = w.shape[0]
    M = B * H * W_
    x2 = x.reshape(M, C)
    w2 = w.reshape(O, C).t()   # [C, O], the transposed view of the stored filter

    if ctx.attr("is_test", False) or ctx.attr("use_global_stats", False):
        y2 = torch.matmul(x2, w2.to(x2.dtype))
        inv = torch.rsqrt(var_in.float() + eps)
        mean, saved_var, mean_out, var_out = mean_in, inv, mean_in, var_in
    else:
        zeros = torch.zeros((C,), dtype=torch.float32, device=x.device)
        ones = torch.ones((C,), dtype=torch.float32, device=x.device)
        args = (x2, w2, zeros, ones, zeros, zeros, float(eps), False, False)
        backend = "kernel"
        if x2.device.type == "cpu":
            from ..tuning import choices as _choices
            backend = _choices.decide("conv2d_bn_fused.backend",
                                      {"m": M, "k": C, "n": O,
                                       "dtype": _choices.dtype_name(x)})
        if backend == "unfused":
            y2, s, ss = unfused_conv1x1_stats(x2, w2)
        elif torch.is_grad_enabled() and (x2.requires_grad or w2.requires_grad):
            # kept for conv2d_bn_fused_grad (or its recompute)
            y2, s, ss = FusedConv1x1BN.apply(*args)
        else:
            y2, s, ss = fused_conv1x1_bn_fwd(*args)
        g = _coll.batch_stats_group(ctx)
        if g is not None:
            # data parallel: K2's column sums summed over the ranks, the
            # global batch's statistics
            s, ss = _coll.sum_stats(g, s, ss)
            M = M * g.size
        mean = s / M
        var = torch.maximum(ss / M - mean * mean, _zero(ss))
        inv = torch.rsqrt(var + eps)
        saved_var = inv
        mean_out = mean_in * momentum + mean * (1 - momentum)
        var_out = var_in * momentum + var * (1 - momentum)
    out = (y2.float() - mean) * inv
    out = out * scale.float() + bias.float()
    if act == "relu":
        out = torch.maximum(out, _zero(out))
    return {"Y": [out.to(x.dtype).reshape(B, H, W_, O)],
            "MeanOut": [mean_out.detach()], "VarianceOut": [var_out.detach()],
            "SavedMean": [mean.detach()], "SavedVariance": [saved_var.detach()]}
