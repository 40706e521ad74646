"""The GPipe schedule over a ``pp`` process group (the port's copy of
``paddle_tpu/parallel/pipeline.py``; reference PipelineTrainer /
SectionWorker, framework/trainer.h:115, section_worker.cc:85,141).

Each rank of the group holds one stage's parameters and runs that stage
on the microbatches as they reach it: at tick t rank r runs microbatch
t - r, so the classic GPipe skew fills and drains the pipe over M + S - 1
ticks. After each tick every rank joins one ``collective_permute``
(``ops/collective.py::permute``) that hands its stage's output to the next
rank; a rank whose tick carries no microbatch skips its compute and sends
zeros. The last rank's outputs are then replicated to every rank of the
group (a broadcast).

The backward is written out, not left to autograd, so that every rank runs
the same collectives in the same order (an autograd graph on rank 0 never
reaches the permutes whose outputs it discards, and would hang the others):
``_GPipe`` keeps each microbatch's stage graph from the forward and walks
the ticks in reverse, each rank differentiating its stage for microbatch
t - r against the cotangent received from the next rank and handing the
input's cotangent back by the reverse permute (the transpose of the
forward's). The replicate's backward (``_Replicate``) keeps the cotangent
on the last rank and gives the others zeros: the cotangent of a replicated
output is itself replicated, and the backward of a sum over the ranks (an
all-reduce) would scale it by S. Gradients then land where one process
would have them:

- a stage's parameters: on its rank only (each rank holds its block of an
  ``@pp_stacked`` parameter);
- the pipeline's input: computed on rank 0 and summed over the group in
  the backward, so the ops before the pipeline (the embeddings) get the
  one-process gradient on every rank, with no sum over pp of their
  parameters' gradients;
- a stage-invariant input (``consts``): each rank's stage's contribution,
  summed over the group.

Parameters read after the pipeline see the same replicated output and the
same cotangent on every rank. Requires homogeneous stages (the activation
keeps its shape), as the JAX schedule does.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Sequence

import torch

#: raised at each call of the schedule (``pipeline_spmd`` and the
#: ``temporal_pipeline`` op on a bound pp group): the proof that a run took
#: the GPipe schedule and not the serial one (``ring_attention.TRACE_COUNT``
#: is the same for the ring)
TRACE_COUNT = 0


def axis_error(axis: str, what: str = "pipeline") -> ValueError:
    """The PT040-worded error for an axis that no bound group carries."""
    from ..ops import collective as _coll
    mesh = {a: g.size for a, g in sorted(_coll.bound_groups().items())}
    return ValueError(
        f"{what} axis {axis!r} is not an axis of the mesh {mesh}; add it to the "
        f"DistributedStrategy mesh_shape (the verifier flags this statically as PT040)")


def telemetry(axis: str, stages: int, microbatches: int) -> None:
    """The schedule's counters, as the JAX package records them at a trace:
    each call counts its S x (M + S - 1) stage spans, and the gauges hold
    the last schedule's ticks and bubble fraction (S - 1) / (M + S - 1)."""
    global TRACE_COUNT
    TRACE_COUNT += 1
    from ..observability.metrics import REGISTRY as _OBS
    S, M = stages, microbatches
    _OBS.counter("pipeline_traces_total",
                 "GPipe schedule traces by pipe axis", axis=axis).inc()
    _OBS.counter("pipeline_stage_spans_total",
                 "stage executions scheduled (S per tick, M+S-1 ticks)",
                 axis=axis).inc(S * (M + S - 1))
    _OBS.gauge("pipeline_schedule_ticks",
               "ticks (fill+steady+drain) of the last traced schedule",
               axis=axis).set(M + S - 1)
    _OBS.gauge("pipeline_bubble_fraction",
               "(S-1)/(M+S-1), the GPipe fill/drain overhead of the last "
               "traced schedule", axis=axis).set((S - 1) / (M + S - 1))


def _permute(x: torch.Tensor, group, pairs) -> torch.Tensor:
    from ..ops import collective as _coll
    return _coll.permute_packed([x], group, pairs)[0]


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    from ..ops import collective as _coll
    _coll.record_collective("allreduce", x, group)
    return _coll.all_reduce_sum(x, group)


class _GPipe(torch.autograd.Function):
    """The schedule's forward and its written-out backward (module
    docstring). ``run(params, h, mb, stage, consts) -> h`` runs one stage on
    one microbatch; ``x`` is [M, mb, ...]; ``n_params`` of ``leaves`` are
    this rank's stage parameters (blocks [1, ...]), the rest the consts.
    Returns [M, mb, ...]: the outputs on the last rank, zeros elsewhere."""

    @staticmethod
    def forward(ctx, run, group, n_params, x, *leaves):
        S, me, M = group.size, group.rank, x.shape[0]
        grad = any(ctx.needs_input_grad)
        params = [p.detach().requires_grad_(p.requires_grad) for p in leaves[:n_params]]
        consts = [c.detach().requires_grad_(c.requires_grad) for c in leaves[n_params:]]
        fwd = [(i, i + 1) for i in range(S - 1)]
        saved: List[Any] = [None] * M
        out = torch.zeros_like(x)
        state = torch.zeros_like(x[0])
        for t in range(M + S - 1):
            mb = t - me
            if 0 <= mb < M:
                inp = (x[mb] if me == 0 else state).detach()
                if grad:
                    inp.requires_grad_(x.requires_grad or me > 0)
                with torch.enable_grad() if grad else contextlib.nullcontext():
                    y = run([p[0] for p in params], inp, mb, me, consts)
                if grad:
                    saved[mb] = (inp, y)
                send = y.detach()
                if me == S - 1:
                    out[mb] = send
            else:
                send = torch.zeros_like(state)
            if t < M + S - 2:
                state = _permute(send, group, fwd)
        ctx.run_state = (group, saved, params, consts, x.requires_grad)
        return out

    @staticmethod
    def backward(ctx, dout):
        group, saved, params, consts, x_grad = ctx.run_state
        ctx.run_state = None
        S, me, M = group.size, group.rank, dout.shape[0]
        back = [(i, i - 1) for i in range(1, S)]
        leaves = params + consts
        dleaves = [torch.zeros_like(v) if v.requires_grad else None for v in leaves]
        dx = torch.zeros_like(dout)
        recv = torch.zeros_like(dout[0])
        for t in reversed(range(M + S - 1)):
            mb = t - me
            send = torch.zeros_like(recv)
            if 0 <= mb < M and saved[mb] is not None:
                inp, y = saved[mb]
                saved[mb] = None
                cot = dout[mb] if me == S - 1 else recv
                wrt = [(-1, inp)] if inp.requires_grad else []
                wrt += [(j, v) for j, v in enumerate(leaves) if v.requires_grad]
                if wrt and y.requires_grad:
                    gs = torch.autograd.grad(y, [v for _, v in wrt], cot, allow_unused=True)
                    for (j, _), g in zip(wrt, gs):
                        if g is None:
                            continue
                        if j < 0:
                            send = g
                            if me == 0:
                                dx[mb] = g
                        else:
                            dleaves[j] += g
            if t > 0:
                recv = _permute(send, group, back)
        # the input's cotangent lives on rank 0 and the consts' are each
        # rank's stage's share: both summed over the group, so every rank
        # holds the one-process gradient
        dx = _all_reduce(dx, group) if x_grad else None
        n = len(params)
        for j in range(n, len(leaves)):
            if dleaves[j] is not None:
                dleaves[j] = _all_reduce(dleaves[j], group)
        return (None, None, None, dx, *dleaves)


class _Replicate(torch.autograd.Function):
    """The last rank's buffer broadcast to every rank of the group (the
    JAX ``psum(b * (idx == S-1))``). The cotangent of the replicated value
    is the same on every rank, so the backward keeps it on the last rank
    and gives the others zeros: no collective, and no factor S."""

    @staticmethod
    def forward(ctx, x, group):
        from ..ops import collective as _coll
        ctx.last = group.rank == group.size - 1
        _coll.record_collective("broadcast", x, group)
        return _coll.broadcast(x.detach().contiguous(), group, group.size - 1)

    @staticmethod
    def backward(ctx, dout):
        return (dout if ctx.last else torch.zeros_like(dout)), None


def gpipe(run: Callable, params: Sequence[torch.Tensor], x: torch.Tensor, group,
          consts: Sequence[torch.Tensor] = (), axis: str = "pp") -> torch.Tensor:
    """The schedule over ``group``: ``run(stage_params, h, mb, stage,
    consts) -> h`` one stage of microbatch ``mb``; ``params`` this rank's
    blocks [1, ...] of the stacked parameters; ``x`` [M, mb, ...];
    ``consts`` passed to every stage whole. Returns [M, mb, ...] on every
    rank of the group. Records the telemetry and the ``pipeline_schedule``
    timeline phase."""
    from ..observability import timeline as _timeline
    S, M = group.size, x.shape[0]
    telemetry(axis, S, M)
    with _timeline.phase("pipeline_schedule", cat="pipeline", axis=axis, stages=S,
                         microbatches=M, ticks=M + S - 1):
        out = _GPipe.apply(run, group, len(params), x, *params, *consts)
        return _Replicate.apply(out, group)


def pipeline_spmd(stage_fn: Callable, stacked_params: Any, x: torch.Tensor, group=None,
                  axis: str = "pp", consts: Any = None) -> torch.Tensor:
    """Run a homogeneous S-stage pipeline over microbatches, one stage a
    rank of the group bound to ``axis`` (or ``group``).

    stage_fn(params_one_stage, x_mb) -> y_mb of x_mb's shape, called as
    stage_fn(params, x_mb, consts) when ``consts`` is given;
    params_one_stage is a tuple with the stage axis removed.
    stacked_params: a tensor or a sequence of tensors with a leading stage
    axis: S (the whole stack; this rank takes its block) or 1 (its block).
    x: [M, mb, ...] microbatched. Returns [M, mb, ...] after all S stages,
    on every rank of the group. Raises the PT040-worded ValueError when no
    group is bound to ``axis``."""
    from ..ops import collective as _coll
    g = group if group is not None else _coll.bound(axis)
    if g is None:
        raise axis_error(axis)
    single = isinstance(stacked_params, torch.Tensor)
    leaves = [stacked_params] if single else list(stacked_params)
    S = g.size
    local = [p.narrow(0, g.rank, 1) if p.shape[0] == S and S > 1 else p for p in leaves]
    for p in local:
        if p.shape[0] != 1:
            raise ValueError(f"pipeline_spmd: a stacked parameter of {p.shape[0]} stages "
                             f"over an axis of {S} ranks; the port runs one stage a rank")
    cs = [] if consts is None else ([consts] if isinstance(consts, torch.Tensor)
                                    else list(consts))

    def run(ps, h, mb, stage, cvals):
        args = (ps[0] if single else tuple(ps), h)
        if consts is not None:
            args += (cvals[0] if isinstance(consts, torch.Tensor) else tuple(cvals),)
        return stage_fn(*args)

    return gpipe(run, local, x, g, cs, axis)
