"""The ``temporal_pipeline`` op: a ``device_guard``-stage stack run by the
GPipe schedule (the port's copy of ``paddle_tpu/ops/pipeline_op.py``;
reference PipelineTrainer / SectionWorker, framework/trainer.h:115,
section_worker.cc:85,141, the cut points from PipelineOptimizer,
optimizer.py:2985).

The op carries one template sub-block (the stage body, over stage 0's
variable names) and the per-position parameter stacks [S, ...]
(``PipelineOptimizer``'s rewrite, ``optimizer.py::_rewrite_temporal_pipeline``).
The template runs through the executor's block runner, once a stage and a
microbatch, with the stage's parameters, the activation and the
microbatch's slice of each batch-riding const bound under the template's
names.

With a ``pp`` group of ``num_stages`` ranks bound (a ``CompiledProgram``
whose mesh has the axis), each rank holds its stage's block [1, ...] of
every stack and the op runs ``parallel/pipeline.py``'s GPipe schedule:
M + S - 1 ticks, a permute to the next rank after each, the last rank's
outputs replicated. Otherwise (one process, or a pp axis of another size)
it runs the serial schedule: each microbatch through the S stages in
order, as the JAX op does off the mesh; the parameters must then be whole.

Inputs:  X [B, ...] (split here into M microbatches), Params: the K
         stacks, Consts: stage-invariant variables read from the
         enclosing block (the attention mask bias).
Attrs:   sub_block, in_var / template_out (the template's activation
         names), param_vars (aligned with Params), const_vars,
         batch_const_vars / defer_const_vars (the rewrite's static
         classification of the consts that ride the batch),
         num_stages S, num_microbatches M, axis.
Output:  Out [B, ...] after all S stages.

Gradient: the registry's generic grad, autograd through the lowering. On
the serial path that is autograd through the loops. On the pipe it is
``_GPipe``'s written-out backward, the reverse schedule, whose collectives
every rank runs in the same order. The executor keeps the forward's graph
for the grad op; on the recompute path (``Executor._reuse_forward`` off)
the grad op reruns the whole forward schedule, collectives included, on
every rank, then the backward: the same sequence on every rank, twice the
forward's permutes.

RNG: the template's ops draw with the program seed folded with the stage
index (``SubBlockRunner.folded``), so each stage draws its own stream, on
the card too (the kernels' ``DeviceSeed`` takes the folded seed).
Microbatches within a step share a stage's stream, as in the JAX op.
"""
from __future__ import annotations

import torch

from ..core.registry import register

#: the salt the stage index is folded into the program seed with
STAGE_SALT = 0x57A6E


def _infer_shape(op, block):
    """Out mirrors X (homogeneous stages preserve the activation shape)."""
    x = block.find_var_recursive(op.inputs["X"][0])
    for n in op.outputs.get("Out", []):
        v = block.create_var(n, x.shape, x.dtype)
        v.stop_gradient = False


def _gloo_pipe(op):
    """A pipeline over a gloo group is not captured: gloo's calls are on
    the host."""
    from . import collective as _coll
    g = _coll.bound(op.attr("axis", "pp"))
    if g is not None and g.size > 1 and g.backend == "gloo":
        return "op 'temporal_pipeline' permutes over gloo, whose calls are on the host"
    return None


def _classify(ctx, consts, cvars, B):
    """(batch-riding indices, stage-invariant indices) of the consts, from
    the rewrite's static classification (the runtime shape decides only
    the deferred ones, and hand-built ops without the attrs)."""
    batch_names = ctx.attr("batch_const_vars", None)
    defer_names = set(ctx.attr("defer_const_vars", []) or [])
    batch_idx, static_idx = [], []
    for i, c in enumerate(consts):
        if batch_names is None or cvars[i] in defer_names:
            riding = c.dim() >= 1 and c.shape[0] == B
        else:
            riding = cvars[i] in batch_names
            if riding and (c.dim() < 1 or c.shape[0] != B):
                raise ValueError(
                    f"temporal_pipeline: const {cvars[i]!r} was classified "
                    f"batch-riding from its declared shape but has runtime "
                    f"leading dim {tuple(c.shape)} != batch {B}")
        (batch_idx if riding else static_idx).append(i)
    return batch_idx, static_idx


@register("temporal_pipeline", infer_shape=_infer_shape, capture_refusal=_gloo_pipe)
def temporal_pipeline(ctx, ins):
    from . import collective as _coll
    x = ins["X"][0]
    params = list(ins.get("Params", ()))
    consts = list(ins.get("Consts", ()))
    S = int(ctx.attr("num_stages"))
    M = int(ctx.attr("num_microbatches", 1))
    axis = ctx.attr("axis", "pp")
    in_var = ctx.attr("in_var")
    # the template block is stage 0's ops, so the per-stage result is read
    # under stage 0's output name
    out_var = ctx.attr("template_out")
    pvars = list(ctx.attr("param_vars", []))
    cvars = list(ctx.attr("const_vars", []))
    blk_idx = int(ctx.attr("sub_block"))
    runner = ctx.block_runner
    if ctx.abstract:
        return {"Out": [torch.empty_like(x)]}
    if runner is None:
        raise RuntimeError("temporal_pipeline needs the executor's sub-block "
                           "runner (it cannot be evaluated standalone)")
    B = x.shape[0]
    if B % M:
        raise ValueError(f"temporal_pipeline: batch {B} not divisible by "
                         f"num_microbatches {M}")
    mb = B // M
    batch_idx, static_idx = _classify(ctx, consts, cvars, B)
    keep = frozenset([out_var])
    runners = {}

    def run(stage_params, h, i, stage, cvals):
        """Stage ``stage`` on microbatch ``i``: the template over the
        stage's parameters, ``h`` and the microbatch's consts."""
        env = {in_var: h}
        env.update(zip(pvars, stage_params))
        for j in batch_idx:
            env[cvars[j]] = cvals[j].narrow(0, i * mb, mb)
        for j in static_idx:
            env[cvars[j]] = cvals[j]
        r = runners.get(stage)
        if r is None:
            r = runners[stage] = runner.folded(stage, STAGE_SALT)
        return r(blk_idx, env, keep)[out_var]

    xs = x.reshape((M, mb) + tuple(x.shape[1:]))
    g = _coll.bound(axis)
    if g is not None and g.size == S and S > 1:
        from ..parallel import pipeline as _pipe
        for p in params:
            if p.shape[0] != 1:
                raise ValueError(
                    f"temporal_pipeline: over a {axis!r} group of {S} ranks each rank "
                    f"holds its stage's block [1, ...] of a stacked parameter, got "
                    f"{tuple(p.shape)} (shard the stacks with "
                    f"PipelineOptimizer.pp_param_rules())")
        ys = _pipe.gpipe(run, params, xs, g, consts, axis)
    else:
        for p in params:
            if p.shape[0] != S:
                raise ValueError(
                    f"temporal_pipeline: the serial schedule runs all {S} stages and "
                    f"needs each stacked parameter whole, got {tuple(p.shape)}")
        outs = []
        for i in range(M):
            h = xs[i]
            for s in range(S):
                h = run([p[s] for p in params], h, i, s, consts)
            outs.append(h)
        ys = torch.stack(outs)
    return {"Out": [ys.reshape((B,) + tuple(ys.shape[2:]))]}
