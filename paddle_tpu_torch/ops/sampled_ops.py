"""Sampled and hierarchical output-layer ops (the port's copy of ``nce`` and
``hsigmoid`` from ``paddle_tpu/ops/sampled_ops.py``).

``nce`` draws its negatives in the graph from the port's counter-derived
generator (``extra_ops.counter_randint``), so a captured step draws anew at
every replay. ``hsigmoid`` walks a complete binary tree over the classes by
the label's bits. The weight rows are taken through ``tensor_ops.take_rows``,
whose gradient adds them in a fixed order.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.registry import register
from .extra_ops import counter_randint
from .tensor_ops import take_rows


@register("nce", nondiff_inputs=("Label",))
def nce(ctx, ins):
    """Cost [B, 1]: the binary NLL of the true class against
    ``num_neg_samples`` negatives drawn uniformly from the classes (one
    draw for the batch), with the uniform sampler's log(k / N)
    correction."""
    x = ins["Input"][0]
    label = ins["Label"][0].reshape(-1).long()
    w = ins["Weight"][0]
    b = ins.get("Bias", [None])[0]
    n_classes = int(ctx.attr("num_total_classes"))
    k = int(ctx.attr("num_neg_samples", 10))
    neg = counter_randint(ctx, (k,), n_classes)
    true_logit = torch.sum(x * take_rows(w, label), dim=1, keepdim=True)
    neg_logit = x @ take_rows(w, neg).t()
    if b is not None:
        true_logit = true_logit + take_rows(b, label)[:, None]
        neg_logit = neg_logit + take_rows(b, neg)[None, :]
    log_kq = math.log(k / n_classes)
    pos_cost = -F.logsigmoid(true_logit - log_kq)
    neg_cost = -torch.sum(F.logsigmoid(-(neg_logit - log_kq)), dim=1, keepdim=True)
    return {"Cost": [pos_cost + neg_cost]}


def hsigmoid_num_nodes(num_classes: int) -> int:
    """The internal nodes of the complete binary tree over the classes (the
    layer's weight rows)."""
    depth = max(1, math.ceil(math.log2(max(num_classes, 2))))
    return 2 ** depth - 1


@register("hsigmoid", nondiff_inputs=("Label",))
def hsigmoid(ctx, ins):
    """Cost [B, 1]: the sum over the label's root-to-leaf path of binary
    logistic losses. At depth d the node is 2^d - 1 + (label >> (depth -
    d)) and the branch is bit depth - 1 - d of the label (1: right)."""
    x = ins["Input"][0]
    label = ins["Label"][0].reshape(-1).long()
    w = ins["W"][0]
    b = ins.get("Bias", [None])[0]
    depth = max(1, math.ceil(math.log2(max(int(ctx.attr("num_classes")), 2))))
    cost = 0.0
    for d in range(depth):
        node = (2 ** d - 1) + (label >> (depth - d))
        bit = (label >> (depth - 1 - d)) & 1
        logit = torch.sum(x * take_rows(w, node), dim=1)
        if b is not None:
            logit = logit + take_rows(b.reshape(-1), node)
        cost = cost - F.logsigmoid((1.0 - 2.0 * bit.to(x.dtype)) * logit)
    cost = cost[:, None]
    return {"Cost": [cost], "PreOut": [cost]}
