"""Beam-search ops over dense [B, K] beams (the port's copy of
``paddle_tpu/ops/beam_ops.py``): ``beam_init``, ``beam_search``,
``beam_append`` and ``beam_search_decode``.

Every shape is static and nothing is read back to the host, so a decode
loop of these ops is captured into one CUDA graph: ``beam_append`` writes
its column by a mask against the step tensor, never by ``int(t)``.

Ties. ``jax.lax.top_k`` gives the lower index first among equal values and
``jnp.argsort`` is stable; ``torch.topk`` promises no order for ties on the
card. So ``beam_search`` takes its top K from a stable descending sort
(``tensor_ops.top_k_lower_first``, as the ``top_k`` op does), and
``beam_search_decode`` sorts with ``stable=True``. Ties are common: at step
0 every beam but the first starts at -1e9, and in float32 -1e9 + logp
rounds to -1e9 exactly.

Dtypes: ``ParentIdx`` is int32 and the ids int64, as the JAX lowerings
declare them (the JAX package runs with x64 off, so its ids are int32 in
value).
"""
from __future__ import annotations

import torch

from ..core.registry import EMPTY_VAR, register
from ..framework import convert_dtype
from .tensor_ops import top_k_lower_first

_NEG = -1e9


def _mk_var(block, name, shape, dtype):
    if name == EMPTY_VAR:
        return
    v = block.find_var_recursive(name)
    if v is None:
        v = block.create_var(name, tuple(shape), dtype)
    else:   # made by the layer: fill in the inferred shape and dtype
        v.shape = tuple(shape)
        v.dtype = convert_dtype(dtype)
    v.stop_gradient = True


def _beam_search_infer(op, block):
    """The outputs take PreScores' [B, K] shape (Scores may come flat, [B*K,
    V], which the meta-tensor inference cannot unflatten for a dynamic B)."""
    bk = block.find_var_recursive(op.inputs["PreScores"][0]).shape
    _mk_var(block, op.outputs["SelectedIds"][0], bk, "int64")
    _mk_var(block, op.outputs["SelectedScores"][0], bk, "float32")
    _mk_var(block, op.outputs["ParentIdx"][0], bk, "int32")
    _mk_var(block, op.outputs["FinishedOut"][0], bk, "bool")


def candidates(pre_scores, scores, finished, end_id):
    """The [B, K*V] candidate scores of one step: PreScores [B, K] plus the
    step's log-probs [B, K, V] (or flat [B*K, V]); a finished beam's only
    candidate is ``end_id`` at its unchanged score, every other is -1e9."""
    finished = finished.bool()
    if scores.ndim == 2:
        scores = scores.reshape(pre_scores.shape[0], pre_scores.shape[1], -1)
    B, K, V = scores.shape
    cand = pre_scores[:, :, None] + scores
    cand = torch.where(finished[:, :, None], torch.full_like(cand, _NEG), cand)
    frozen = torch.where(finished, pre_scores, cand[:, :, end_id])
    end = torch.arange(V, device=cand.device) == end_id
    cand = torch.where(end, frozen[:, :, None], cand)
    return cand.reshape(B, K * V)


@register("beam_search", grad=None, infer_shape=_beam_search_infer,
          nondiff_inputs=("PreIds", "PreScores", "Scores", "Finished"))
def beam_search(ctx, ins):
    """One beam step. PreScores [B, K] cumulative log-probs, Scores [B, K, V]
    (or [B*K, V]) the step's log-probs, Finished [B, K] bool (PreIds is
    taken for the reference's signature). Outputs SelectedIds [B, K],
    SelectedScores [B, K], ParentIdx [B, K] int32, FinishedOut [B, K]."""
    pre_scores = ins["PreScores"][0]
    finished = ins["Finished"][0].bool()
    V = ins["Scores"][0].shape[-1]
    flat = candidates(pre_scores, ins["Scores"][0], finished, ctx.attr("end_id", 1))
    top_scores, top_idx = top_k_lower_first(flat, pre_scores.shape[1])
    parent = torch.div(top_idx, V, rounding_mode="floor")
    token = top_idx - parent * V
    new_finished = torch.take_along_dim(finished, parent, dim=1) | (token == ctx.attr("end_id", 1))
    return {"SelectedIds": [token], "SelectedScores": [top_scores],
            "ParentIdx": [parent.to(torch.int32)], "FinishedOut": [new_finished]}


@register("beam_append", grad=None, nondiff_inputs=("IdsBuf", "Parent", "NewIds", "StepIdx"))
def beam_append(ctx, ins):
    """The [B, K, T] token buffer reordered by the parent pointers, with the
    new tokens written at column StepIdx (a [1] tensor on the device)."""
    buf = ins["IdsBuf"][0]
    parent = ins["Parent"][0].long()
    new_ids = ins["NewIds"][0].to(buf.dtype)
    t = ins["StepIdx"][0].reshape(-1)[0]
    reordered = torch.take_along_dim(buf, parent[:, :, None], dim=1)
    col = torch.arange(buf.shape[2], device=buf.device) == t
    return {"Out": [torch.where(col[None, None, :], new_ids[:, :, None], reordered)]}


@register("beam_search_decode", grad=None, nondiff_inputs=("Ids", "Parents", "Scores"))
def beam_search_decode(ctx, ins):
    """Backtrack the recorded beams to sentences. Ids / Parents [B, T, K] per
    step, Scores [B, K] final cumulative scores. SentenceIds [B, K, T]
    (every token after the first ``end_id`` is ``end_id``) and
    SentenceScores [B, K], both sorted best-first."""
    ids, parents, scores = ins["Ids"][0], ins["Parents"][0], ins["Scores"][0]
    end_id = ctx.attr("end_id", 1)
    B, T, K = ids.shape
    beam = torch.arange(K, device=ids.device).expand(B, K)
    toks = []
    for t in range(T - 1, -1, -1):
        toks.append(torch.take_along_dim(ids[:, t, :], beam, dim=1))
        beam = torch.take_along_dim(parents[:, t, :].long(), beam, dim=1)
    seqs = torch.stack(toks[::-1], dim=2)                          # [B, K, T]
    is_end = (seqs == end_id).to(torch.int32)
    seqs = torch.where(torch.cumsum(is_end, dim=-1) - is_end > 0,
                       torch.full_like(seqs, end_id), seqs)
    order = torch.argsort(-scores, dim=1, stable=True)
    seqs = torch.take_along_dim(seqs, order[:, :, None], dim=1)
    return {"SentenceIds": [seqs.long()],
            "SentenceScores": [torch.take_along_dim(scores, order, dim=1)]}


@register("beam_init", grad=None, nondiff_inputs=("BatchRef",))
def beam_init(ctx, ins):
    """The first beam state for BatchRef's batch: ScoresInit [B, K] (0 for
    beam 0, -1e9 for the rest, so identical first beams do not give
    duplicate candidates), FinishedInit [B, K] false, IdsBufInit [B, K, T]
    of ``bos_id``."""
    B = ins["BatchRef"][0].shape[0]
    K, T = ctx.attr("beam_size"), ctx.attr("buf_len")
    # made by fills on the device: no host value is copied in a captured step
    first = torch.arange(K, device=ctx.device) == 0
    scores = torch.where(first, torch.zeros((), device=ctx.device),
                         torch.full((B, K), _NEG, dtype=torch.float32, device=ctx.device))
    return {"ScoresInit": [scores],
            "FinishedInit": [torch.zeros((B, K), dtype=torch.bool, device=ctx.device)],
            "IdsBufInit": [torch.full((B, K, T), ctx.attr("bos_id", 0), dtype=torch.int64,
                                      device=ctx.device)]}
