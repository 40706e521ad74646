"""In-graph metric ops (the port's copy of ``accuracy`` from
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
