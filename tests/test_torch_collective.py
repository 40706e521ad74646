"""The port's 13 collective op types (``paddle_tpu_torch/ops/collective.py``)
at world 2 and 4 over gloo on the CPU: each rank's output against numpy and
against the JAX lowering under ``shard_map`` on the CPU mesh, the
gradients of the linear ones against the JAX vjp, the identity with no
group bound, and the registry and layer wrappers against the JAX package's.

The ranks are processes started by the port's launcher
(``tests/torch_dist_runner.py``), one launch a world for every case, each
bounded by a timeout on the launch and on the process group. f32: outputs
within rtol 1e-5 / atol 1e-6 (a sum's order may differ from numpy's)."""
import functools
import inspect
import os

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu_torch.parallel import launch as pt_launch
from tests import torch_dist_runner as runner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)
TYPES = [t for t, _, _ in runner.OP_CASES]


def run_ranks(tmp, world, cases, timeout=120):
    """Launch ``world`` ranks of the runner over ``cases``; their results."""
    codes = pt_launch.launch(world, [os.path.join(ROOT, "tests", "torch_dist_runner.py"),
                                     str(tmp), ",".join(cases)],
                             log_dir=str(tmp / "logs"), timeout=timeout,
                             env={"PYTHONPATH": ROOT})
    logs = "".join(open(tmp / "logs" / f"rank{r}.log").read()[-3000:] for r in range(world))
    assert codes == [0] * world, logs
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module", params=[2, 4])
def world_results(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"coll{request.param}")
    return request.param, run_ranks(tmp, request.param, ["ops"])


def _expected(t, w):
    """numpy: every rank's output of op ``t`` at world ``w``."""
    xs = [runner.op_input(t, r, w) for r in range(w)]
    attrs = dict((c, a) for c, a, _ in runner.OP_CASES)[t]
    if t == "c_allreduce_sum":
        return [np.sum(xs, 0)] * w
    if t == "c_allreduce_avg":
        return [np.sum(xs, 0) / w] * w
    if t == "c_allreduce_max":
        return [np.max(xs, 0)] * w
    if t == "c_allreduce_min":
        return [np.min(xs, 0)] * w
    if t == "c_allreduce_prod":
        return [np.prod(xs, 0)] * w
    if t == "c_allgather":
        return [np.concatenate(xs, 0)] * w
    if t == "c_reducescatter":
        return np.split(np.sum(xs, 0), w, axis=0)
    if t == "c_broadcast":
        return [xs[attrs["root"]]] * w
    if t == "alltoall":
        return [np.concatenate([np.split(xs[j], w, axis=1)[r] for j in range(w)], 0)
                for r in range(w)]
    if t == "collective_permute":
        return [xs[(r - 1) % w] for r in range(w)]
    if t == "reshard":
        return [np.split(xs[r], w, axis=0)[r] for r in range(w)]
    return xs   # the stream syncs: the identity


def _shard_map():
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    sig = inspect.signature(shard_map).parameters
    ck = ({"check_vma": False} if "check_vma" in sig else
          {"check_rep": False} if "check_rep" in sig else {})
    return shard_map, ck


def _jax_op(t, w, attrs=None):
    """The JAX package's lowering of ``t`` under ``shard_map`` over ``w``
    CPU devices, as a function of the ranks' stacked inputs."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from paddle_tpu.core import registry as jreg
    shard_map, ck = _shard_map()
    mesh = Mesh(np.array(jax.devices()[:w]), ("dp",))
    attrs = dict(attrs if attrs is not None else
                 dict((c, a) for c, a, _ in runner.OP_CASES)[t], axis_name="dp")

    def local(x):
        ctx = jreg.LowerCtx(attrs, mesh=mesh)
        return jreg.get(t).lower(ctx, {"X": [x[0]]})["Out"][0][None]

    return shard_map(local, mesh=mesh, in_specs=P("dp"), out_specs=P("dp"), **ck)


@functools.lru_cache(maxsize=None)
def _jax_results(t, w):
    """The JAX lowering's outputs of the ranks' stacked inputs and, for the
    linear ops, its vjp of the ranks' cotangents (one trace for both)."""
    import jax
    xs = np.stack([runner.op_input(t, r, w) for r in range(w)])
    if t not in runner.GRAD_OPS:
        return np.asarray(_jax_op(t, w)(xs)), None
    out, vjp = jax.vjp(_jax_op(t, w), xs)
    cts = np.stack([runner.cotangent(t, r, tuple(out.shape[1:])) for r in range(w)])
    return np.asarray(out), np.asarray(vjp(cts)[0])


@pytest.mark.parametrize("t", TYPES)
def test_collective_op_matches_numpy_and_the_jax_lowering(t, world_results):
    w, res = world_results
    want = _expected(t, w)
    got = [r[f"ops/{t}"] for r in res]
    for r in range(w):
        np.testing.assert_allclose(got[r], want[r], **TOL, err_msg=f"rank {r}")
    jax_out = _jax_results(t, w)[0]
    for r in range(w):
        np.testing.assert_allclose(got[r], jax_out[r], **TOL, err_msg=f"rank {r} vs JAX")


@pytest.mark.parametrize("t", runner.GRAD_OPS)
def test_collective_gradient_matches_the_jax_vjp(t, world_results):
    """The gradient of sum_r <op(x)_r, w_r> with respect to each rank's x,
    against the JAX lowering's vjp under shard_map."""
    w, res = world_results
    want = _jax_results(t, w)[1]
    for r in range(w):
        np.testing.assert_allclose(res[r][f"grad/{t}"], want[r], **TOL,
                                   err_msg=f"rank {r}")


def test_reshard_gather_and_unbound_identity(world_results):
    w, res = world_results
    xs = [runner.op_input("reshard", r, w) for r in range(w)]
    jax_out = np.asarray(_jax_op("reshard", w, {"src_dim": 0, "dst_dim": -1})(np.stack(xs)))
    for r in range(w):
        np.testing.assert_array_equal(res[r]["ops/reshard_gather"], np.concatenate(xs, 0))
        np.testing.assert_array_equal(res[r]["ops/reshard_gather"], jax_out[r])
        # no group bound: the identity, as the JAX op outside a mesh
        np.testing.assert_array_equal(res[r]["ops/unbound"],
                                      runner.op_input("c_allreduce_sum", r, w))


def test_registry_holds_the_collectives_and_the_jax_metadata():
    from paddle_tpu.core import registry as jreg
    from paddle_tpu.ops import collective as jcoll
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.ops import collective as tcoll
    missing = sorted(set(jreg._REGISTRY) - set(treg._REGISTRY))
    assert missing == [], missing
    assert tcoll.COLLECTIVE_OPS == jcoll.COLLECTIVE_OPS
    for t in TYPES:
        a, b = treg.get(t), jreg.get(t)
        assert (a.grad, a.nondiff_inputs, a.nondiff_outputs) == \
            (b.grad, b.nondiff_inputs, b.nondiff_outputs), t
    for t in jcoll.COLLECTIVE_OPS:
        assert tcoll.is_collective(t)
    op = type("Op", (), {"type": "c_allgather", "attr": lambda s, n, d=None: d})()
    assert tcoll.collective_axis(op) == jcoll.collective_axis(op) == "dp"


def test_collective_layers_append_the_jax_ops():
    """layers/collective.py's wrappers append the JAX package's op types and
    attrs, and run as the identity on one process."""
    def build(pkg):
        from importlib import import_module
        lc = import_module(f"{pkg.__name__}.layers.collective")
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            x = pkg.data("x", [4], "float32")
            outs = [lc._allreduce(x), lc._allreduce(x, reduce_type="max"),
                    lc._broadcast(x, root=1), lc._c_allreduce(x, reduce_type="avg"),
                    lc._c_allgather(x, nranks=2), lc._c_broadcast(x),
                    lc._c_reducescatter(x), lc._c_sync_calc_stream(x),
                    lc._c_sync_comm_stream(x)]
        return main, outs

    jm, _ = build(fluid)
    tm, touts = build(pt)
    assert [(o.type, o.attrs) for o in tm.global_block().ops] == \
        [(o.type, o.attrs) for o in jm.global_block().ops]
    with pytest.raises(ValueError, match="reduce_type"):
        from paddle_tpu_torch.layers import collective as lc
        with pt.program_guard(pt.Program(), pt.Program()):
            lc._allreduce(pt.data("y", [4], "float32"), reduce_type="mean")
    x = np.arange(8, dtype=np.float32).reshape(2, 4)
    outs = pt.Executor(pt.CPUPlace()).run(tm, feed={"x": x}, fetch_list=touts)
    for o in outs:
        np.testing.assert_array_equal(o, x)
