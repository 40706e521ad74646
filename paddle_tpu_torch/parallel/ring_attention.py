"""Ring attention: blockwise attention over a sequence-parallel ``sp``
group (the port's copy of ``paddle_tpu/parallel/ring_attention.py``).

Each rank holds its block of the sequence: Q, K, V [B, H, S/n, D] and the
bias [B, 1, 1, S/n]. K, V and the bias rotate around the ring by
``collective_permute`` (``ops/collective.py::permute``, one call a step
for all three); at step t a rank holds source block (rank - t) mod n and
attends its Q rows to it with the flash-attention forward kernel (K1-fwd,
``flash_attn_fwd(..., return_lse=True)``) on the card. The block outputs
and their row LSEs merge by the online-softmax rule: LSE = logaddexp of
the blocks', O = sum of each block's O times exp(its LSE - LSE), in f32.
Under ``causal`` the blocks wholly above the diagonal (source > rank) are
skipped on every rank (the rotation still runs: every rank joins every
permute) and the diagonal block is the kernel's own ``causal``.

The backward (``RingAttention.backward``) rotates K, V, the bias and the
block's dK and dV accumulators (f32), which arrive home after n steps; on
each block it launches the backward kernel (K1-bwd, ``flash_attn_bwd``)
with the *merged* O and LSE, so each block's P is exp(S - LSE) of the whole
row and D = rowsum(dO O) is the whole row's. The S x S matrix never exists.

Dropout: each block draws with the seed folded with (rank, source block),
as the JAX ring folds (``my``, ``src``). On the CPU the same Function runs
the plain versions (``attention_plain(..., return_lse=True)``, and
``attention_bwd_plain`` from the row LSE). On a CUDA tensor that the kernels refuse
(``kernel_refusal``) it raises, as ``impl="pallas"`` does: nothing falls
back.
"""
from __future__ import annotations

import math

import torch

from ..core.registry import DeviceSeed, seed_int
from ..ops import collective as _coll

#: raised at each call (``ring_attention``): the proof that a run took the
#: ring (the JAX package's trace counter)
TRACE_COUNT = 0

#: the salt (rank, source block) is folded into the dropout seed with
RING_SALT = 0x41E6


def fold_seed(seed, *values, salt: int = RING_SALT):
    """``seed`` with ``values`` folded in: an int seed mixed on the host, a
    ``DeviceSeed``'s program seed mixed (the kernel derives the rest from
    the run counter on the card)."""
    base = seed.seed if isinstance(seed, DeviceSeed) else int(seed)
    for v in values:
        base = seed_int(base, int(v), salt)
    if isinstance(seed, DeviceSeed):
        return DeviceSeed(seed.counter, base, seed.salt)
    return base


def _block_fwd(q, k, v, bias, scale, causal, dropout, seed):
    from ..ops.flash_attention import attention_plain, flash_attn_fwd
    if q.device.type == "cpu":
        return attention_plain(q, k, v, bias, scale, causal, dropout, seed, return_lse=True)
    return flash_attn_fwd(q, k, v, bias, scale, causal, dropout, seed, return_lse=True)


def _block_bwd(q, k, v, bias, o, lse, do, scale, causal, dropout, seed):
    from ..ops.flash_attention import attention_bwd_plain, flash_attn_bwd
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, bias, o, do, scale, causal, dropout, seed, lse)
    return flash_attn_bwd(q, k, v, bias, o, lse, do, scale, causal, dropout, seed)


class RingAttention(torch.autograd.Function):
    """The ring's forward and backward over ``group`` (module docstring);
    the bias gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, causal, dropout, seed, group):
        n, me = group.size, group.rank
        ring = [(i, (i + 1) % n) for i in range(n)]
        kb, vb, bb = k, v, bias
        o_acc = lse = None
        for t in range(n):
            src = (me - t) % n
            if not (causal and src > me):
                o_b, lse_b = _block_fwd(q, kb, vb, bb, scale, causal and src == me, dropout,
                                        fold_seed(seed, me, src) if dropout else 0)
                if o_acc is None:
                    o_acc, lse = o_b.float(), lse_b
                else:
                    new = torch.logaddexp(lse, lse_b)
                    o_acc = (o_acc * torch.exp(lse - new).unsqueeze(-1)
                             + o_b.float() * torch.exp(lse_b - new).unsqueeze(-1))
                    lse = new
            if t < n - 1:
                kb, vb, bb = _coll.permute_packed([kb, vb, bb], group, ring)
        o = o_acc.to(q.dtype).contiguous()
        lse = lse.contiguous()
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.args = (scale, causal, dropout, seed, group)
        return o

    @staticmethod
    def backward(ctx, do):
        if torch.is_grad_enabled():
            raise NotImplementedError("a second-order gradient through ring attention is "
                                      "not supported: it needs a double-backward kernel of "
                                      "flash_attn_bwd (ROADMAP, Parked)")
        q, k, v, bias, o, lse = ctx.saved_tensors
        scale, causal, dropout, seed, group = ctx.args
        n, me = group.size, group.rank
        ring = [(i, (i + 1) % n) for i in range(n)]
        do = do.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        kb, vb, bb = k, v, bias
        for t in range(n):
            src = (me - t) % n
            if not (causal and src > me):
                gq, gk, gv = _block_bwd(q, kb, vb, bb, o, lse, do, scale,
                                        causal and src == me, dropout,
                                        fold_seed(seed, me, src) if dropout else 0)
                dq += gq.float()
                dk += gk.float()
                dv += gv.float()
            # the accumulators travel with their block and are home after n moves
            if t < n - 1:
                kb, vb, bb, dk, dv = _coll.permute_packed([kb, vb, bb, dk, dv], group,
                                                            ring)
            else:
                dk, dv = _coll.permute_packed([dk, dv], group, ring)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None)


def ring_attention(q, k, v, bias, scale=None, dropout=0.0, causal=False, seed=0,
                   group=None, axis: str = "sp"):
    """softmax(Q K^T * scale + bias) V over the sequence blocks of the
    ``sp`` group (``group``, else the one bound to ``axis``): q/k/v
    [B, H, S/n, D] this rank's block, bias [B, 1, 1, S/n] or None; ``seed``
    an int or a ``DeviceSeed``. Differentiable in q, k and v. Raises the
    PT040-worded ValueError when no group is bound, and ValueError for
    tensors the kernels do not take on the card."""
    global TRACE_COUNT
    g = group if group is not None else _coll.bound(axis)
    if g is None:
        from .pipeline import axis_error
        raise axis_error(axis, "sequence")
    TRACE_COUNT += 1
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        from ..ops.flash_attention import kernel_refusal
        why = kernel_refusal(q, k, v, bias)
        if why is not None:
            raise ValueError(f"ring_attention: the flash-attention kernels refuse this "
                             f"block: {why}")
    return RingAttention.apply(q, k, v, bias, float(scale), bool(causal), float(dropout),
                               seed, g)
