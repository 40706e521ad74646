"""In-graph metric ops (the port's copy of ``accuracy``, ``auc`` and
``chunk_eval`` from ``paddle_tpu/ops/metrics_ops.py``)."""
from __future__ import annotations

import torch

from ..core.registry import register

# chunk_eval's tag schemes (reference chunk_eval_op.h:119):
# scheme -> (num_tag_types, tag_begin, tag_inside, tag_end, tag_single)
_CHUNK_SCHEMES = {"IOB": (2, 0, 1, -1, -1), "IOE": (2, -1, 0, 1, -1),
                  "IOBES": (4, 0, 1, 2, 3), "plain": (1, -1, -1, -1, -1)}


@register("accuracy", grad=None, nondiff_inputs=("Out", "Indices", "Label"))
def accuracy(ctx, ins):
    """Top-k accuracy: Indices [N,k] from top_k, Label [N,1]."""
    idx, label = ins["Indices"][0], ins["Label"][0]
    if label.ndim == 1:
        label = label[:, None]
    correct = (idx == label.to(idx.dtype)).any(dim=1)
    ncorrect = correct.float().sum()
    return {"Accuracy": [(ncorrect / idx.shape[0]).reshape((1,))],
            "Correct": [ncorrect.to(torch.int32).reshape((1,))],
            "Total": [torch.full((1,), idx.shape[0], dtype=torch.int32, device=ctx.device)]}


@register("auc", grad=None, nondiff_inputs=("Predict", "Label"))
def auc(ctx, ins):
    """Streaming ROC AUC over fixed histogram buckets: each prediction's
    positive probability p (Predict [N, 2], last column) falls in bucket
    ``int(p * num_thresholds)`` (truncated, then clipped to [0,
    num_thresholds]), and its label adds one to that bucket of StatPos or
    StatNeg, the persistable [num_thresholds + 1] histograms. The AUC is
    the trapezoid sum over the reversed cumulative counts.

    The histograms grow by a scatter-add into their fixed size, which a CUDA
    graph captures (``torch.bincount`` would read its length back to the
    host). The counts are whole numbers below 2^24 in f32, so the sums are
    exact in any order the card's atomics take. The AUC is computed in
    float32, as the JAX package computes it (x64 off), and returned as the
    float64 its variable is declared."""
    pred = ins["Predict"][0]
    label = ins["Label"][0].reshape(-1)
    stat_pos, stat_neg = ins["StatPos"][0], ins["StatNeg"][0]
    nt = ctx.attr("num_thresholds", 4095)
    bucket = (pred[:, -1] * nt).to(torch.int32).clamp(0, nt)
    is_pos = (label > 0).to(stat_pos.dtype)
    pos_out = stat_pos.index_add(0, bucket, is_pos)
    neg_out = stat_neg.index_add(0, bucket, 1 - is_pos)
    tp = torch.cumsum(pos_out.flip(0), 0)
    fp = torch.cumsum(neg_out.flip(0), 0)
    tpr = tp / torch.clamp_min(tp[-1], 1.0)
    fpr = fp / torch.clamp_min(fp[-1], 1.0)
    zero = torch.zeros((1,), dtype=tpr.dtype, device=tpr.device)
    tpr0 = torch.cat([zero, tpr[:-1]])
    fpr0 = torch.cat([zero, fpr[:-1]])
    auc_val = torch.sum((fpr - fpr0) * (tpr + tpr0) / 2.0)
    return {"AUC": [auc_val.reshape((1,)).to(torch.float64)],
            "StatPosOut": [pos_out], "StatNegOut": [neg_out]}


@register("chunk_eval", grad=None)
def chunk_eval(ctx, ins):
    """Chunk-level precision, recall and F1 of the predicted tag sequences
    Inference [B, T] against Label [B, T] (IOB / IOE / IOBES / plain), the
    steps past SeqLength [B] read as Other. As the JAX lowering: a chunk
    begins and ends by rules on consecutive tag pairs, a chunk runs to the
    next end-flagged transition (a suffix minimum), and two chunks match
    when their begin, end and type agree."""
    inf, lab = ins["Inference"][0], ins["Label"][0]
    lengths = ins.get("SeqLength", [None])[0]
    scheme = ctx.attr("chunk_scheme", "IOB")
    nct = int(ctx.attr("num_chunk_types"))
    excluded = list(ctx.attr("excluded_chunk_types", []) or [])
    if scheme not in _CHUNK_SCHEMES:
        raise ValueError(f"chunk_eval: unknown chunk_scheme {scheme!r}")
    num_tag, t_beg, t_in, t_end, t_sg = _CHUNK_SCHEMES[scheme]
    B, T = inf.shape
    dev = inf.device
    pos = torch.arange(T, device=dev)[None, :].expand(B, T)

    def analyze(tags):
        tags = tags.long()
        if lengths is not None:
            tags = torch.where(pos < lengths.reshape(B, 1).long(), tags, nct * num_tag)
        tag = tags % num_tag
        typ = tags // num_tag
        ptag = torch.cat([torch.full((B, 1), -1, dtype=torch.int64, device=dev), tag[:, :-1]], 1)
        ptyp = torch.cat([torch.full((B, 1), nct, dtype=torch.int64, device=dev), typ[:, :-1]], 1)
        is_other, p_other = typ == nct, ptyp == nct
        no = torch.zeros_like(is_other)
        begin = torch.where(
            p_other, ~is_other,
            torch.where(is_other, no,
                        torch.where(typ != ptyp, ~no,
                                    (tag == t_beg) | (tag == t_sg)
                                    | (((tag == t_in) | (tag == t_end))
                                       & ((ptag == t_end) | (ptag == t_sg))))))
        end_at = torch.where(
            p_other, no,
            torch.where(is_other | (typ != ptyp), ~no,
                        torch.where((ptag == t_beg) | (ptag == t_in),
                                    (tag == t_beg) | (tag == t_sg),
                                    (ptag == t_end) | (ptag == t_sg))))
        flagged = torch.where(end_at, pos, T)
        suffix = torch.cummin(flagged.flip(1), dim=1)[0].flip(1)
        next_end = torch.cat([suffix[:, 1:], torch.full((B, 1), T, dtype=torch.int64,
                                                        device=dev)], 1)
        return begin, typ, torch.where(begin, next_end, -1)

    b_i, t_i, e_i = analyze(inf)
    b_l, t_l, e_l = analyze(lab)
    keep_i, keep_l = b_i, b_l
    for ex in excluded:
        keep_i = keep_i & (t_i != ex)
        keep_l = keep_l & (t_l != ex)
    n_inf, n_lab = keep_i.sum(), keep_l.sum()
    n_cor = (keep_i & keep_l & (t_i == t_l) & (e_i == e_l)).sum()
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    p = torch.where(n_inf > 0, n_cor / torch.clamp_min(n_inf, 1), zero)
    r = torch.where(n_lab > 0, n_cor / torch.clamp_min(n_lab, 1), zero)
    f1 = torch.where(p + r > 0, 2 * p * r / torch.clamp_min(p + r, 1e-12), zero)

    def as1(v, dt):
        return v.to(dt).reshape(1)

    return {"Precision": [as1(p, torch.float32)], "Recall": [as1(r, torch.float32)],
            "F1-Score": [as1(f1, torch.float32)],
            "NumInferChunks": [as1(n_inf, torch.int32)],
            "NumLabelChunks": [as1(n_lab, torch.int32)],
            "NumCorrectChunks": [as1(n_cor, torch.int32)]}
