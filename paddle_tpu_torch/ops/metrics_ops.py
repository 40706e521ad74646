"""In-graph metric ops (the port's copy of ``accuracy`` and ``auc`` from
``paddle_tpu/ops/metrics_ops.py``)."""
from __future__ import annotations

import torch

from ..core.registry import register


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
