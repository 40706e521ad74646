"""Recompile-risk pass: what in this program will churn the compile cache
(the port's copy of ``paddle_tpu/analysis/recompile.py``).

In the port a "compile" is a CUDA-graph capture: the executor's cache of
steps is keyed by (program id, version, feed shapes/dtypes, fetch names,
seed, scope, the tuner's state token), one warm-up and one capture per key
(``core/executor.py``). This pass reads that key's static ingredients off
the program and flags the churn-prone ones before the first run. The codes,
severities and texts are the JAX package's (where a text says XLA compile,
read CUDA-graph capture):

- PT030: a data var with a dynamic (-1) dim beyond the leading batch dim.
  Every distinct value of that dim is a new feed signature -> a new XLA
  compile. Bucket/pad instead (the classic NLP var-length trap).
- PT031: a dynamic leading (batch) dim -- one compile per distinct batch
  size; expected for the last partial batch, worth knowing about.
- PT032: ops of one type disagreeing on ``is_test`` inside one program --
  the signature of a partial Program.clone(for_test=True) merge; train and
  eval graphs should be separate programs (separate cache entries), not an
  in-place mix that bumps ``_version`` on every toggle.
- PT033: stochastic ops with ``random_seed`` unset: seed 0 is silently
  baked into the compiled step (the seed is a cache-key component, and
  determinism across processes hinges on it being chosen, not defaulted).
- PT034: dynamic batch dim under fused multi-step execution (the verify
  gate passes ``fuse_k`` from ``Executor.run_fused``): in the JAX package
  the fused cache key is (per-step feed signature, K), and each fused epoch
  also compiles a K=1 remainder entry for the trailing partial chunk; in
  the port K steps are K replays of the per-step graph, so each batch size
  is a capture of its own.
"""
from __future__ import annotations

from typing import Dict, List, Set

from .diagnostics import Diagnostic
from .pass_base import AnalysisPass, PassContext, register_pass

#: op types whose lowerings draw per-step random numbers (the JAX package's
#: list: the lowerings that consume its per-step PRNG key)
STOCHASTIC_OPS = frozenset({
    "dropout", "gaussian_random", "uniform_random",
    "truncated_gaussian_random", "randint", "sampling_id", "random_crop",
    "uniform_random_batch_size_like", "gaussian_random_batch_size_like",
    "nce", "dpsgd",
})


@register_pass
class RecompileRiskPass(AnalysisPass):
    name = "recompile"

    def run(self, ctx: PassContext) -> List[Diagnostic]:
        diags: List[Diagnostic] = []
        prog = ctx.program
        for b in prog.blocks:
            for n, v in b.vars.items():
                if not v.is_data:
                    continue
                dyn = [i for i, d in enumerate(v.shape) if d == -1]
                if any(i > 0 for i in dyn):
                    diags.append(Diagnostic(
                        "PT030", f"data var {n!r} shape {list(v.shape)} has "
                                 f"dynamic non-batch dim(s) "
                                 f"{[i for i in dyn if i > 0]}: every "
                                 f"distinct extent is a fresh XLA compile; "
                                 f"pad or bucket it", block_idx=b.idx,
                        var=n))
                elif dyn:
                    diags.append(Diagnostic(
                        "PT031", f"data var {n!r} has a dynamic batch dim: "
                                 f"each distinct batch size compiles its "
                                 f"own cache entry (keep batch sizes "
                                 f"uniform, pad the last batch)",
                        block_idx=b.idx, var=n))
                    if ctx.fuse_k and ctx.fuse_k > 1:
                        # fused intent: the megastep key is (per-step feed
                        # signature, K), so batch variety multiplies by the
                        # K values in play -- and every fused epoch also
                        # compiles the K=1 remainder entry for the trailing
                        # partial chunk. Expected churn, but worth naming
                        # before the first run.
                        diags.append(Diagnostic(
                            "PT034", f"data var {n!r} runs under fused "
                                     f"multi-step execution (K="
                                     f"{ctx.fuse_k}): every distinct "
                                     f"(K, batch) pair compiles its own "
                                     f"megastep, plus a K=1 entry for the "
                                     f"trailing remainder chunk",
                            block_idx=b.idx, var=n))
        self._check_is_test_mix(ctx, diags)
        self._check_seed(ctx, diags)
        return diags

    def _check_is_test_mix(self, ctx, diags):
        by_type: Dict[str, Set[bool]] = {}
        where = {}
        for b in ctx.program.blocks:
            for op in b.ops:
                if "is_test" in op.attrs:
                    by_type.setdefault(op.type, set()).add(
                        bool(op.attrs["is_test"]))
                    where.setdefault((op.type, bool(op.attrs["is_test"])),
                                     (b, op))
        for t, vals in sorted(by_type.items()):
            if len(vals) > 1:
                b, op = where[(t, False)]
                diags.append(Diagnostic.for_op(
                    "PT032", f"op type {t!r} appears with both "
                             f"is_test=True and is_test=False in one "
                             f"program (partial clone(for_test=True)?); "
                             f"keep train and eval as separate programs",
                    b, op))

    def _check_seed(self, ctx, diags):
        if ctx.program.random_seed is not None:
            return
        stoch = sorted({op.type for b in ctx.program.blocks for op in b.ops
                        if op.type in STOCHASTIC_OPS
                        and not op.attr("is_test")})
        if stoch:
            diags.append(Diagnostic(
                "PT033", f"program has stochastic ops {stoch} but "
                         f"random_seed is unset: the compiled step bakes "
                         f"in seed 0 (set program.random_seed for chosen, "
                         f"reproducible randomness)"))
