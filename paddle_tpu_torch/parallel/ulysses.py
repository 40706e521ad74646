"""Ulysses (DeepSpeed-style) sequence parallelism: one all-to-all that
scatters the heads and gathers the sequence (the port's copy of
``paddle_tpu/parallel/ulysses.py``).

Each rank of the ``sp`` group holds Q, K, V [B, H, S/n, D] and its bias
block [B, 1, 1, S/n]. One tiled ``all_to_all`` (Q, K and V packed in one
call) re-shards them to [B, H/n, S, D]; the bias blocks are all-gathered
to [B, 1, 1, S]; every rank then runs the whole sequence's attention for
its slice of the heads, through the flash-attention kernels on the card
(K1-fwd with the LSE, and K1-bwd in the backward) and the plain versions
on the CPU; one all-to-all takes the output back to [B, H, S/n, D]. Two
collective rounds where the ring takes n, so it wins when S/n is small
against a hop's latency and loses when H < n (``fused_attention`` keeps
``"auto"`` on the ring and takes Ulysses for ``impl="ulysses"``).

``UlyssesAttention`` writes the backward out: the all-to-all of dO, the
backward kernel on the local heads, and one all-to-all of dQ, dK and dV
packed, so every rank runs the same collectives in the same order. The
dropout seed is folded with the rank.
"""
from __future__ import annotations

import math

import torch

from .ring_attention import fold_seed

#: raised at each call (``ulysses_attention``): the proof that a run took
#: the all-to-all path
TRACE_COUNT = 0

#: the salt the rank is folded into the dropout seed with
ULYSSES_SALT = 0x0175


def _a2a(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    from ..ops import collective as _coll
    _coll.record_collective("alltoall", x, group)
    return _coll.all_to_all(x, group, split_axis, concat_axis)


class UlyssesAttention(torch.autograd.Function):
    """The scatter-compute-gather schedule and its backward (module
    docstring); the bias gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, causal, dropout, seed, group):
        from ..ops import collective as _coll
        from ..ops import flash_attention as _fa
        # [3, B, H, S/n, D] -> [3, B, H/n, S, D]: heads scattered, sequence gathered
        qkv = _a2a(torch.stack([q, k, v]), group, 2, 3)
        qh, kh, vh = (t.contiguous() for t in qkv.unbind(0))
        bf = None
        if bias is not None:
            _coll.record_collective("allgather", bias, group)
            bf = _coll.all_gather(bias, group, 3).contiguous()
        s = fold_seed(seed, group.rank, salt=ULYSSES_SALT) if dropout else 0
        if q.device.type == "cpu":
            out = _fa.attention_plain(qh, kh, vh, bf, scale, causal, dropout, s)
            lse = None
        else:
            out, lse = _fa.flash_attn_fwd(qh, kh, vh, bf, scale, causal, dropout, s,
                                          return_lse=True)
        ctx.save_for_backward(qh, kh, vh, bf, out, lse)
        ctx.args = (scale, causal, dropout, s, group)
        # [B, H/n, S, D] -> [B, H, S/n, D]
        return _a2a(out, group, 2, 1).contiguous()

    @staticmethod
    def backward(ctx, do):
        if torch.is_grad_enabled():
            raise NotImplementedError("a second-order gradient through Ulysses attention "
                                      "is not supported: it needs a double-backward kernel "
                                      "of flash_attn_bwd (ROADMAP, Parked)")
        from ..ops import flash_attention as _fa
        qh, kh, vh, bf, out, lse = ctx.saved_tensors
        scale, causal, dropout, s, group = ctx.args
        doh = _a2a(do.contiguous(), group, 1, 2).contiguous()
        if qh.device.type == "cpu":
            dq, dk, dv = _fa.attention_bwd_plain(qh, kh, vh, bf, out, doh, scale, causal,
                                                 dropout, s)
        else:
            dq, dk, dv = _fa.flash_attn_bwd(qh, kh, vh, bf, out, lse, doh, scale, causal,
                                            dropout, s)
        g = _a2a(torch.stack([dq, dk.to(dq.dtype), dv.to(dq.dtype)]), group, 3, 2)
        dq, dk, dv = g.unbind(0)
        return dq, dk, dv, None, None, None, None, None, None


def ulysses_attention(q, k, v, bias, scale=None, dropout=0.0, causal=False, seed=0,
                      group=None, axis: str = "sp"):
    """softmax(Q K^T * scale + bias) V over the sequence blocks of the
    ``sp`` group (``group``, else the one bound to ``axis``) by the
    head-scatter all-to-all: q/k/v [B, H, S/n, D] this rank's block, bias
    [B, 1, 1, S/n] or None. Requires H divisible by the group's size
    (ValueError, the JAX wording). Differentiable in q, k and v."""
    global TRACE_COUNT
    from ..ops import collective as _coll
    g = group if group is not None else _coll.bound(axis)
    if g is None:
        from .pipeline import axis_error
        raise axis_error(axis, "sequence")
    n, H = g.size, q.shape[1]
    if H % n != 0:
        raise ValueError(
            f"ulysses_attention: heads per mp shard ({H}) not divisible by "
            f"{axis}={n} (use impl='ring' instead)")
    TRACE_COUNT += 1
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return UlyssesAttention.apply(q, k, v, bias, float(scale), bool(causal), float(dropout),
                                  seed, g)
