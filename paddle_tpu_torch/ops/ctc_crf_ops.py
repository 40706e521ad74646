"""The linear-chain CRF (the port's copy of ``linear_chain_crf`` and
``crf_decoding`` from ``paddle_tpu/ops/ctc_crf_ops.py``).

Emission [B, T, N] over padded steps, Length [B], Transition [N+2, N]: row 0
the start scores, row 1 the stop scores, rows 2.. the pairwise scores
(``trans[i, j]``: tag i then tag j). The JAX package's two ``lax.scan``s
over T are Python loops over the static padded T, as the port's ``scan``
op is one; a row's steps past its length leave its state unchanged, by a
mask, so no length is read on the host.

The gold path's scores are picked by one-hot products, not by indexing:
the gradient of ``start[label]`` or ``trans[prev, next]`` through indexing
adds the rows' cotangents with atomics on the card, in no fixed order, and
a step would not reproduce bit for bit. A one-hot product sums one score
and zeros, so its value is the indexed score exactly.
"""
from __future__ import annotations

import torch

from ..core.registry import register


def _crf_parts(transition):
    return transition[0], transition[1], transition[2:]


def _one_hot(ids, n, dtype):
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(dtype)


def _pick(onehot, scores):
    """sum over the tag axis of ``onehot * scores``: the score of each
    one-hot tag, exactly."""
    return torch.sum(onehot * scores, dim=-1)


@register("linear_chain_crf", nondiff_inputs=("Label", "Length"))
def linear_chain_crf(ctx, ins):
    """Negative log-likelihood of the gold tag paths, LogLikelihood [B, 1]
    = logZ - score(gold), as the JAX lowering (and the reference kernel's
    ``return -ll``): callers minimise it as it is."""
    emission = ins["Emission"][0]
    em = emission.float()
    label = ins["Label"][0].long()
    lens = ins["Length"][0].reshape(-1).long()
    start, stop, trans = _crf_parts(ins["Transition"][0].float())
    B, T, N = em.shape
    hot = _one_hot(label, N, em.dtype)                      # [B, T, N]

    # numerator: the score of the gold path
    t_mask = (torch.arange(T, device=em.device)[None, :] < lens[:, None]).to(em.dtype)
    gold = torch.sum(_pick(hot, em) * t_mask, dim=1)
    gold = gold + _pick(hot[:, 0], start)
    pair = torch.einsum("bti,ij,btj->bt", hot[:, :-1], trans, hot[:, 1:])
    gold = gold + torch.sum(pair * t_mask[:, 1:], dim=1)
    last = torch.take_along_dim(label, torch.clamp_min(lens - 1, 0)[:, None], dim=1)[:, 0]
    gold = gold + _pick(_one_hot(last, N, em.dtype), stop)

    # denominator: the forward algorithm
    a = start[None, :] + em[:, 0]                               # [B, N]
    for t in range(1, T):
        nxt = torch.logsumexp(a[:, :, None] + trans[None, :, :], dim=1) + em[:, t]
        a = torch.where((t < lens)[:, None], nxt, a)
    logz = torch.logsumexp(a + stop[None, :], dim=1)
    return {"LogLikelihood": [(logz - gold)[:, None].to(emission.dtype)]}


@register("crf_decoding", grad=None, nondiff_inputs=("Emission", "Transition", "Length"))
def crf_decoding(ctx, ins):
    """Viterbi: the max-product forward pass with back-pointers, then the
    backtrace. ViterbiPath [B, T] int64, 0 past each row's length. Ties go
    to the first maximum, as ``jnp.argmax``'s (``torch.argmax`` returns the
    first maximal index, on the CPU and on the card)."""
    em = ins["Emission"][0].float()
    lens = ins["Length"][0].reshape(-1).long()
    start, stop, trans = _crf_parts(ins["Transition"][0].float())
    B, T, N = em.shape
    a = start[None, :] + em[:, 0]
    bps = []
    for t in range(1, T):
        scores = a[:, :, None] + trans[None, :, :]              # [B, N, N]
        best = torch.amax(scores, dim=1) + em[:, t]
        bp = torch.argmax(scores, dim=1)
        active = (t < lens)[:, None]
        a = torch.where(active, best, a)
        bps.append(torch.where(active, bp, torch.full_like(bp, -1)))
    tag = torch.argmax(a + stop[None, :], dim=1)                # the last step's tag
    tags = []
    for bp in reversed(bps):
        prev = torch.take_along_dim(bp, tag[:, None], dim=1)[:, 0]
        tags.append(tag)
        tag = torch.where(prev < 0, tag, prev)                  # inactive steps: stay
    path = torch.stack([tag] + tags[::-1], dim=1)
    valid = torch.arange(T, device=em.device)[None, :] < lens[:, None]
    return {"ViterbiPath": [torch.where(valid, path, torch.zeros_like(path))]}
