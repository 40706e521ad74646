"""Pass framework: AnalysisPass base, PassContext, pass registry (the
port's copy of ``paddle_tpu/analysis/pass_base.py``).

A pass is a stateless object with ``run(ctx) -> [Diagnostic]``; the context
carries the program plus the optional run intent (feed/fetch names) and
memoizes program-wide facts every pass needs (block reference graph,
root availability set) so N passes don't re-derive them.

The analog of the reference's ``ir::Pass`` registry (pass.h / PassRegistry):
passes register by name, ``default_passes()`` is the verifier pipeline, and
callers can run a subset (``analysis.verify(p, passes=["wellformed"])``).

Distributed intent is ROADMAP item 13 (c)'s, as are the passes that read it
(``distributed``, ``shardplan``): a ``strategy`` raises here, naming the
item (``split_strategy``), as ``verify(auto_shard=True)`` does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..core.registry import EMPTY_VAR  # noqa: F401  (re-exported to passes)
from ..framework import Operator, Program
from .diagnostics import Diagnostic


def block_attr_indices(op: Operator) -> List[Tuple[str, object]]:
    """(attr name, raw value) for every attr that names a sub-block: keys
    ending in ``_block``. ``else_block=-1`` is the documented "absent"
    sentinel (see Program._prune) and is NOT returned."""
    out = []
    for k in sorted(op.attrs):
        if not k.endswith("_block"):
            continue
        v = op.attrs[k]
        if k == "else_block" and v == -1:
            continue
        out.append((k, v))
    return out


def sub_block_indices(op: Operator, program: Program) -> List[int]:
    """Valid sub-block indices referenced by ``op`` (malformed attrs are
    PT005 findings of the wellformed pass, skipped here)."""
    out = []
    for _, v in block_attr_indices(op):
        if isinstance(v, int) and not isinstance(v, bool) \
                and 0 <= v < len(program.blocks):
            out.append(v)
    return out


#: why a strategy, the distributed checks or the auto-sharding planner raise
ITEM_13 = ("ROADMAP item 13 (c) (distributed analysis): the port's DistributedStrategy "
           "runs data parallel (compiler.py), but the PT04x collective and sharding checks (analysis/distributed.py), "
           "the auto-sharding planner PT07x (analysis/shardplan.py) and the "
           "memory planner's sharding divisors and comm_compression residuals are "
           "not ported")


def split_strategy(strategy):
    """verify()'s ``strategy`` argument as (DistributedStrategy,
    BuildStrategy): (None, None) for None. Anything else raises
    NotImplementedError naming ROADMAP item 13 (c)."""
    if strategy is None:
        return None, None
    raise NotImplementedError(f"strategy={type(strategy).__name__}: {ITEM_13}")


class PassContext:
    """Program + run intent + memoized program-wide facts."""

    def __init__(self, program: Program,
                 feed_names: Optional[Sequence[str]] = None,
                 fetch_names: Optional[Sequence[str]] = None,
                 strategy=None, mem_budget: Optional[int] = None,
                 batch: Optional[int] = None,
                 fuse_k: Optional[int] = None):
        self.program = program
        # empty == unknown intent, same as None: an executor run with no
        # fetch_list must not flag the whole program dead (PT010), and
        # every consumer below branches on None, not truthiness
        self.feed_names = list(feed_names) if feed_names else None
        self.fetch_names = list(fetch_names) if fetch_names else None
        split_strategy(strategy)   # distributed intent raises (ROADMAP item 13 (c))
        self.mem_budget = mem_budget
        self.batch = batch
        # fused intent: the executor's run_fused gate passes its K so the
        # PT03x recompile lint reasons about the per-step feed signature
        # and K, not the K stacked steps it runs
        self.fuse_k = fuse_k
        self._referencing: Optional[Dict[int, List[Tuple[int, int]]]] = None
        self._roots: Optional[Set[str]] = None

    # -- block reference graph ---------------------------------------------
    def referencing_ops(self) -> Dict[int, List[Tuple[int, int]]]:
        """sub-block idx -> [(block idx, op idx) of each op referencing it]."""
        if self._referencing is None:
            refs: Dict[int, List[Tuple[int, int]]] = {}
            for b in self.program.blocks:
                for oi, op in enumerate(b.ops):
                    for si in sub_block_indices(op, self.program):
                        refs.setdefault(si, []).append((b.idx, oi))
            self._referencing = refs
        return self._referencing

    def orphan_blocks(self) -> List[int]:
        refs = self.referencing_ops()
        return [b.idx for b in self.program.blocks[1:] if b.idx not in refs]

    # -- availability roots ------------------------------------------------
    def feedable(self) -> Set[str]:
        """Names assumed present in the trace env before any op runs:
        feeds (``is_data`` vars, plus the explicit feed list when given)
        and persistable state (parameters, optimizer moments -- the startup
        program owns their initialization)."""
        if self._roots is None:
            roots: Set[str] = set(self.feed_names or ())
            for b in self.program.blocks:
                for n, v in b.vars.items():
                    if v.is_data or v.persistable:
                        roots.add(n)
            self._roots = roots
        return self._roots


class AnalysisPass:
    """Base class: subclasses set ``name`` and implement ``run``."""

    name: str = ""

    def run(self, ctx: PassContext) -> List[Diagnostic]:
        raise NotImplementedError

    def __repr__(self):
        return f"<AnalysisPass {self.name}>"


_PASS_REGISTRY: Dict[str, type] = {}
_DEFAULT_ORDER: List[str] = []


def register_pass(cls=None, *, default: bool = True):
    """Class decorator: register an AnalysisPass subclass by its ``name``.
    ``default=False`` registers it as opt-in (not part of verify())."""

    def deco(klass):
        name = klass.name
        if not name:
            raise ValueError(f"{klass!r} has no pass name")
        if name in _PASS_REGISTRY:
            raise ValueError(f"analysis pass {name!r} already registered")
        _PASS_REGISTRY[name] = klass
        if default:
            _DEFAULT_ORDER.append(name)
        return klass

    return deco(cls) if cls is not None else deco


def get_pass(name: str) -> AnalysisPass:
    try:
        return _PASS_REGISTRY[name]()
    except KeyError:
        raise KeyError(
            f"analysis pass {name!r} is not registered "
            f"(have: {sorted(_PASS_REGISTRY)})") from None


def registered_passes() -> List[str]:
    return sorted(_PASS_REGISTRY)


def default_passes() -> List[str]:
    return list(_DEFAULT_ORDER)


def run_passes(program: Program, passes: Optional[Sequence[str]] = None,
               feed_names: Optional[Sequence[str]] = None,
               fetch_names: Optional[Sequence[str]] = None,
               strategy=None, mem_budget: Optional[int] = None,
               batch: Optional[int] = None,
               fuse_k: Optional[int] = None) -> List[Diagnostic]:
    ctx = PassContext(program, feed_names=feed_names, fetch_names=fetch_names,
                      strategy=strategy, mem_budget=mem_budget, batch=batch,
                      fuse_k=fuse_k)
    diags: List[Diagnostic] = []
    for name in (passes if passes is not None else default_passes()):
        diags.extend(get_pass(name).run(ctx))
    return diags


def op_input_names(op: Operator) -> List[str]:
    return [n for ns in op.inputs.values() for n in ns if n != EMPTY_VAR]


def op_output_names(op: Operator) -> List[str]:
    return [n for ns in op.outputs.values() for n in ns if n != EMPTY_VAR]
