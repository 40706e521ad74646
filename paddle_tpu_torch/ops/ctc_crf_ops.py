"""CTC and the linear-chain CRF (the port's copy of ``warpctc``,
``ctc_align``, ``linear_chain_crf`` and ``crf_decoding`` from
``paddle_tpu/ops/ctc_crf_ops.py``).

CTC: Logits [B, T, C] over padded steps, Label [B, L] padded, and the
lengths LogitsLength / LabelLength [B]. The forward recursion over the
blank-interleaved label (S = 2L + 1 states) is a Python loop over the static
T, as the JAX ``lax.scan``, differentiated by autograd. Impossible
transitions carry ``NEG = -1e30``, not -inf, so a row whose label cannot fit
its length gives a loss near 1e30, as the JAX lowering does.
``torch.nn.functional.ctc_loss`` is not the lowering: it gives inf on such a
row, and its backward on the card adds with atomics, so a step would not
reproduce bit for bit.

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

NEG = -1e30


def _emissions(logp, ext):
    """``logp`` [B, T, C] at the extended label ``ext`` [B, S]: [B, T, S].
    A product with the one-hot matrix of ``ext`` (one score and zeros, so
    the value is the picked score exactly): its gradient is a product too,
    where ``take_along_dim``'s would add the states' cotangents into the
    blank's column with atomics, in no fixed order on the card."""
    hot = (ext[:, :, None] == torch.arange(logp.shape[2], device=ext.device)).to(logp.dtype)
    return torch.bmm(logp, hot.transpose(1, 2))


@register("warpctc", nondiff_inputs=("Label", "LogitsLength", "LabelLength"))
def warpctc(ctx, ins):
    """CTC loss, Loss [B, 1] = -log p(label | logits), by the forward
    algorithm over the blank-interleaved label. attrs: ``blank`` (default
    0), ``norm_by_times`` (divide by the row's logits length). A row's steps
    past its length leave its state unchanged, by a mask."""
    logits = ins["Logits"][0]
    label = ins["Label"][0].long()
    llen = ins["LogitsLength"][0].reshape(-1).long()
    ylen = ins["LabelLength"][0].reshape(-1).long()
    blank = int(ctx.attr("blank", 0))
    B, T, _ = logits.shape
    L = label.shape[1]
    S = 2 * L + 1
    dev = logits.device

    logp = torch.log_softmax(logits.float(), dim=-1)
    ext = torch.full((B, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = label
    # the skip s-2 -> s is allowed where ext[s] is no blank and differs from ext[s-2]
    can_skip = torch.cat([torch.zeros((B, 2), dtype=torch.bool, device=dev),
                          (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])], dim=1)
    emit = _emissions(logp, ext)                               # [B, T, S]

    neg = torch.full((), NEG, dtype=torch.float32, device=dev)
    alpha = torch.cat([emit[:, 0, :1], torch.where(ylen[:, None] > 0, emit[:, 0, 1:2], neg),
                       neg.expand(B, S - 2)], dim=1)
    pad1 = neg.expand(B, 1)
    pad2 = neg.expand(B, 2)
    for t in range(1, T):
        prev1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        prev2 = torch.where(can_skip, torch.cat([pad2, alpha[:, :-2]], dim=1), neg)
        new = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2) + emit[:, t]
        alpha = torch.where((t < llen)[:, None], new, alpha)
    end = 2 * ylen                                             # the final blank's state
    a_last = torch.take_along_dim(alpha, end[:, None], dim=1)
    a_prev = torch.take_along_dim(alpha, torch.clamp_min(end - 1, 0)[:, None], dim=1)
    loss = -torch.logaddexp(a_last, torch.where((ylen > 0)[:, None], a_prev, neg))
    if ctx.attr("norm_by_times", False):
        loss = loss / torch.clamp_min(llen[:, None].float(), 1.0)
    return {"Loss": [loss.to(logits.dtype)]}


def compact_front(ids, keep, pad):
    """Each row's kept entries moved to the front in order (a stable sort of
    ``~keep``), ``pad`` past the row's count: (out, count)."""
    T = ids.shape[1]
    order = torch.sort((~keep).to(torch.int32), dim=1, stable=True)[1]
    n = keep.sum(dim=1)
    out = torch.take_along_dim(ids, order, dim=1)
    fill = torch.full((), pad, dtype=ids.dtype, device=ids.device)
    return torch.where(torch.arange(T, device=ids.device)[None, :] < n[:, None], out, fill), n


@register("ctc_align", grad=None, nondiff_inputs=("Input", "InputLength"))
def ctc_align(ctx, ins):
    """Greedy CTC decode: the argmax of each step (the first index on ties,
    as ``jnp.argmax``), repeats merged, blanks dropped, the rest moved to the
    front in order. Output [B, T] int32, ``padding_value`` past each row's
    count; OutputLength [B] int64."""
    probs = ins["Input"][0]
    ilen = ins["InputLength"][0].reshape(-1)
    blank = int(ctx.attr("blank", 0))
    B, T = probs.shape[0], probs.shape[1]
    ids = torch.argmax(probs, dim=-1).to(torch.int32)
    prev = torch.cat([torch.full((B, 1), -1, dtype=torch.int32, device=ids.device),
                      ids[:, :-1]], dim=1)
    valid = torch.arange(T, device=ids.device)[None, :] < ilen[:, None]
    keep = (ids != blank) & (ids != prev) & valid
    out, n = compact_front(ids, keep, int(ctx.attr("padding_value", 0)))
    return {"Output": [out], "OutputLength": [n.to(torch.int64)]}


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
