"""The port's API surface against the JAX package's, as ``tests/api_spec.txt``
pins it (``tools/print_signatures.py``).

Every name of the spec, mapped from ``paddle_tpu`` to ``paddle_tpu_torch``
(``tools.ckpt_doctor`` to ``paddle_tpu_torch.tools.ckpt_doctor``), resolves
in the port, except the names of ``NOT_IN_PORT``, each with its reason; and
each of those is indeed absent, so the list cannot go stale. The dygraph
names also keep the JAX package's parameter names in order (a trailing
``place`` / ``device`` keyword may follow). The surface repairs
(``Program.block``, ``Variable.astype_shape``, ``Optimizer.apply_optimize``,
the re-exports of ``io``, ``initializer`` and ``observability``) are held
against the JAX package's behaviour.
"""
import fnmatch
import importlib
import inspect
import json
import os

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu_torch.tools import print_signatures as ps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = os.path.join(ROOT, "tests", "api_spec.txt")

_ITEM_13 = "ROADMAP item 13 (distributed), not ported yet"
#: spec names (globs) the port does not have, with the reason
NOT_IN_PORT = {
    "paddle_tpu.online.*": _ITEM_13 + ": online table publishing",
    "paddle_tpu.resilience.Elastic*": _ITEM_13 + ": the elastic controller",
    "paddle_tpu.resilience.ReshardPlan*": _ITEM_13 + ": checkpoint resharding",
    "paddle_tpu.resilience.VarPlan*": _ITEM_13 + ": checkpoint resharding",
    "paddle_tpu.resilience.apply_reshard": _ITEM_13 + ": checkpoint resharding",
    "paddle_tpu.resilience.layout_from_metas": _ITEM_13 + ": checkpoint resharding",
    "paddle_tpu.resilience.note_world_change": _ITEM_13 + ": the elastic controller",
    "paddle_tpu.resilience.plan_for_checkpoint": _ITEM_13 + ": checkpoint resharding",
    "paddle_tpu.resilience.plan_reshard": _ITEM_13 + ": checkpoint resharding",
    "paddle_tpu.resilience.replan_batch_schedule": _ITEM_13 + ": the elastic controller",
    "paddle_tpu.resilience.shard_regions": _ITEM_13 + ": checkpoint resharding",
    "paddle_tpu.resilience.zero_layout": _ITEM_13 + ": ZeRO sharded state",
    "paddle_tpu.resilience.zero_shard_dim": _ITEM_13 + ": ZeRO sharded state",
    "paddle_tpu.observability.FleetMonitor*": _ITEM_13 + ": the fleet monitor",
    "paddle_tpu.observability.detect_stragglers": _ITEM_13 + ": straggler detection",
    "paddle_tpu.analysis.ShardPlan*": _ITEM_13 + ": the auto-sharding planner",
    "paddle_tpu.analysis.SearchResult": _ITEM_13 + ": the auto-sharding planner",
    "paddle_tpu.analysis.search_plans": _ITEM_13 + ": the auto-sharding planner",
    "paddle_tpu.analysis.strategy_from_dict": _ITEM_13 + ": the auto-sharding planner",
    "paddle_tpu.warmstore.WarmStore.barrier_after_write": _ITEM_13 + ": a multi-host barrier",
    "paddle_tpu.observability.attribute_hlo_text":
        "XLA only: attributes an HLO module's text; the card has no HLO (the port "
        "attributes a profiler trace, observability.attribute_trace)",
    "paddle_tpu.observability.ProgramAttribution.top_copy_pairs":
        "XLA only: the HLO copy pairs of layout churn; the port's attribution has no HLO",
}


def _spec():
    """(path, kind, signature) of each spec line."""
    out = []
    with open(SPEC) as f:
        for line in f:
            path, rest = line.rstrip("\n").split(" ", 1)
            kind = next(k for k in ("class", "method", "def") if rest.startswith(k))
            out.append((path, kind, rest[len(kind):]))
    return out


SPEC_LINES = _spec()


def _excepted(path):
    return next((why for pat, why in NOT_IN_PORT.items() if fnmatch.fnmatch(path, pat)), None)


def _resolve(path):
    """The object at a dotted port path: the longest importable module, then
    attributes. Raises LookupError when it does not resolve."""
    parts = path.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        for a in parts[i:]:
            try:
                obj = getattr(obj, a)
            except (AttributeError, ImportError) as e:
                raise LookupError(f"{path}: {e}") from e
        return obj
    raise LookupError(path)


def test_spec_maps_onto_the_port():
    assert ps.port_name("paddle_tpu.dygraph.guard") == "paddle_tpu_torch.dygraph.guard"
    assert ps.port_name("tools.ckpt_doctor.main") == "paddle_tpu_torch.tools.ckpt_doctor.main"
    assert ps.reference_name("paddle_tpu_torch.tools.ckpt_doctor.main") == \
        "tools.ckpt_doctor.main"
    assert len(SPEC_LINES) > 1000


@pytest.mark.parametrize("module", sorted({".".join(p.split(".")[:2]) if not p.startswith(
    "tools.") else "tools.ckpt_doctor" for p, _, _ in SPEC_LINES}))
def test_every_spec_name_resolves_in_the_port(module):
    """Each module's spec names resolve, but for the listed exceptions."""
    missing, stale = [], []
    for path, _, _ in SPEC_LINES:
        if not (path.startswith(module + ".")):
            continue
        why = _excepted(path)
        try:
            _resolve(ps.port_name(path))
            if why is not None:
                stale.append(path)
        except LookupError:
            if why is None:
                missing.append(path)
    assert not missing, f"not in the port: {missing}"
    assert not stale, f"listed as absent but present (update NOT_IN_PORT): {stale}"


def test_every_exception_matches_a_spec_name():
    paths = [p for p, _, _ in SPEC_LINES]
    for pat in NOT_IN_PORT:
        assert any(fnmatch.fnmatch(p, pat) for p in paths), pat


def _params(obj):
    return list(inspect.signature(obj).parameters)


@pytest.mark.parametrize("path", [p for p, _, _ in SPEC_LINES
                                  if p.startswith("paddle_tpu.dygraph.")])
def test_dygraph_signatures_match(path):
    """The JAX name's parameters, in order; the port may add a trailing
    place / device keyword."""
    want = _params(_resolve(path))
    got = _params(_resolve(ps.port_name(path)))
    assert got[:len(want)] == want, (got, want)
    assert all(p in ("place", "device") for p in got[len(want):]), got


def _printable(path, kind):
    """Whether the printer lists the port's object at a spec path: it is the
    port's own (names owned elsewhere are skipped, as by the JAX package's
    printer), and a method is defined on its class, not inherited."""
    port = ps.port_name(path)
    owner = getattr(_resolve(port), "__module__", "") or ""
    if kind == "method":
        cls, name = port.rsplit(".", 1)
        return name in vars(_resolve(cls)) and owner.split(".")[0] == "paddle_tpu_torch"
    return owner.split(".")[0] == "paddle_tpu_torch"


def test_print_signatures_prints_the_ports_surface(capsys):
    """The printer lists every spec name the port has, under the JAX
    package's names (``comm`` among them since it is ported), and skips the
    module of ROADMAP item 13 (d), ``online``."""
    assert ps.main(["--as-reference"]) == 0
    names = {ln.split(" ", 1)[0] for ln in capsys.readouterr().out.splitlines()}
    want = {p for p, k, _ in SPEC_LINES if _excepted(p) is None and _printable(p, k)}
    assert not want - names, sorted(want - names)
    assert any(n.startswith("paddle_tpu.comm.") for n in names)
    assert not any(n.startswith("paddle_tpu.online.") for n in names)


# -- the surface repairs, against the JAX package ----------------------------------------

def _two_blocks(pkg):
    main = pkg.Program()
    main._create_block()
    main._rollback()
    return main


@pytest.mark.parametrize("idx", [0, 1])
def test_program_block(idx):
    for pkg in (fluid, pt):
        main = _two_blocks(pkg)
        assert main.block(idx) is main.blocks[idx]
    assert _two_blocks(pt).block(idx).idx == _two_blocks(fluid).block(idx).idx


@pytest.mark.parametrize("shape,batch", [((-1, 4), 8), ((3, -1, -1), 2), ((5,), 7), ((), 3)])
def test_variable_astype_shape(shape, batch):
    got, want = [], []
    for pkg, out in ((fluid, want), (pt, got)):
        main = pkg.Program()
        v = main.global_block().create_var("v", shape, "float32")
        out.append(v.astype_shape(batch))
    assert got == want


def _fc_program(pkg, apply):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [4], "float32")
        loss = pkg.layers.mean(pkg.layers.fc(x, 3))
        opt = pkg.optimizer.Adam(0.01)
        if apply:
            pg = opt.backward(loss)
            ops = opt.apply_optimize(loss, startup, pg)
        else:
            ops, pg = opt.minimize(loss)
    return main, ops


@pytest.mark.parametrize("apply", [True, False])
def test_optimizer_apply_optimize_matches_minimize_and_jax(apply):
    """backward + apply_optimize builds what minimize builds, in both
    packages, with the same op types."""
    types = {}
    for pkg in (fluid, pt):
        main, ops = _fc_program(pkg, apply)
        assert [o.type for o in ops] == ["adam", "adam"]
        types[pkg.__name__] = [o.type for o in main.global_block().ops]
    assert types["paddle_tpu"] == types["paddle_tpu_torch"]


def test_io_reexports_executor_and_scope():
    from paddle_tpu_torch.core import executor
    assert pt.io.Executor is executor.Executor is pt.Executor
    assert pt.io.Scope is executor.Scope is pt.Scope
    assert fluid.io.Executor is fluid.Executor and fluid.io.Scope is fluid.Scope
    s = pt.io.Scope()
    s.set_var("a", np.ones(2))
    assert s.new_scope().has_var("a") and s.var_names() == fluid.io.Scope().var_names() + ["a"]


def test_initializer_reexports_variable():
    assert pt.initializer.Variable is pt.framework.Variable
    assert fluid.initializer.Variable is fluid.framework.Variable
    for pkg in (fluid, pt):
        v = pkg.Program().global_block().create_var("w", (2, 3), "float32")
        assert isinstance(v, pkg.initializer.Variable)


def test_observability_read_journal_matches_jax(tmp_path):
    """The same JSONL (a blank line, a torn last line) reads the same."""
    path = tmp_path / "journal.jsonl"
    events = [{"event": "run", "step": i, "wall_s": 0.5 * i} for i in range(3)]
    path.write_text("\n".join(json.dumps(e) for e in events) + "\n\n{\"event\": \"ru")
    got = pt.observability.read_journal(str(path))
    assert got == fluid.observability.read_journal(str(path)) == events
    from paddle_tpu_torch.observability import journal
    assert pt.observability.read_journal is journal.read_journal
