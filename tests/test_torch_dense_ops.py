"""The dense op families (activations, elementwise, reductions, the basic
ops and the math ops): each case of ``paddle_tpu_torch/tools/op_cases.py``
through the JAX package's lowering and the port's on the same numpy
inputs, forward and, where the op is differentiable, the generic
``<op>_grad`` against the JAX vjp with the same seeded cotangents.

Tolerances are each case's (``op_cases``: f32 ``atol 1e-5, rtol 1e-5``,
bf16 ``atol 1e-2, rtol 1e-2``; a case that states another gives its reason). The JAX package runs with x64 off, so
integer outputs are compared by value and kind, not width. The tensor ops'
cases run in ``tests/test_torch_tensor_ops.py`` with the helpers here.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu  # noqa: F401  (registers the JAX op library)
from paddle_tpu.core import registry as jreg
import paddle_tpu_torch  # noqa: F401  (registers the port's op library)
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.tools import op_cases
from paddle_tpu_torch.tools.op_cases import CASES

#: the 99 op types this family group ported, by JAX module
NEW_OPS = {
    "schedules": ["increment", "elementwise_min", "elementwise_pow", "elementwise_mod",
                  "elementwise_floordiv", "floor", "ceil", "cos", "exp", "pow"],
    "activations": ["logsigmoid", "tanh_shrink", "log", "log1p", "rsqrt", "abs",
                    "reciprocal", "softplus", "softsign", "softshrink", "hard_shrink",
                    "thresholded_relu", "relu6", "brelu", "leaky_relu", "elu", "swish",
                    "hard_swish", "hard_sigmoid", "mish", "stanh", "soft_relu", "sin",
                    "acos", "asin", "atan", "cosh", "sinh", "erf", "round"],
    "reduce_ops": ["reduce_mean", "reduce_max", "reduce_min", "reduce_prod", "reduce_all",
                   "reduce_any", "cumsum", "logsumexp"],
    "basic": ["fill_any_like", "fill_zeros_like", "isfinite", "linspace", "range", "shape",
              "logical_and", "logical_or", "logical_xor", "logical_not", "one_hot_v2",
              "where", "randint", "truncated_gaussian_random"],
    "tensor_ops": ["arg_max", "arg_min", "argsort", "diag", "embedding_bag", "expand_as",
                   "eye", "flatten", "flatten2", "flip", "gather_nd", "index_select",
                   "lookup_table", "meshgrid", "pad", "pad2d", "reshape", "reverse", "roll",
                   "scatter", "scatter_nd_add", "shard_index", "squeeze", "stack",
                   "strided_slice", "tile", "transpose", "unsqueeze", "unstack"],
    "math_ops": ["bmm", "cross_entropy2", "dot", "huber_loss", "l2_normalize", "log_loss",
                 "p_norm", "smooth_l1_loss"],
}
TENSOR_OPS = set(NEW_OPS["tensor_ops"])
# the update ops' cases run in tests/test_torch_optimizers.py (a bf16 parameter
# beside f32 state: ``Case.slot_dtypes``)
DENSE = sorted(k for k, c in CASES.items()
               if c.op not in TENSOR_OPS and c.op not in op_cases.UPDATE_OPS)


def _to_jax(a, dtype):
    a = np.array(a)   # np.ascontiguousarray would make a 0-d array 1-d
    return jnp.asarray(a, jnp.bfloat16) if (dtype == "bfloat16" and a.dtype.kind == "f") \
        else jnp.asarray(a)


def jax_forward(name):
    c = CASES[name]
    return jreg.get(c.op).lower(jreg.LowerCtx(dict(c.attrs)),
                                {s: [_to_jax(a, c.dtype) for a in v] for s, v in c.ins.items()})


def assert_close(got, want, tol, what):
    a, b = op_cases.numpy_outs({"x": [want]})["x"][0], op_cases.numpy_outs({"x": [got]})["x"][0]
    assert a.shape == b.shape, (what, a.shape, b.shape)
    # ids and integer outputs: JAX runs with x64 off (int32), the port keeps int64
    assert a.dtype.kind == b.dtype.kind, (what, a.dtype, b.dtype)
    np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64), err_msg=what,
                               equal_nan=True, **tol)


def check_forward(name):
    c = CASES[name]
    jouts = jax_forward(name)
    touts = op_cases.forward(name, "cpu")
    compared = 0
    for slot, tvals in touts.items():
        assert len(tvals) == len(jouts[slot]), slot
        for j, t in zip(jouts[slot], tvals):
            if j is None:   # JAX's v2 reshapes leave XShape empty
                continue
            assert_close(t, j, c.tol, f"{name} slot {slot}")
            compared += 1
    assert compared >= 1


def check_grad(name):
    c = CASES[name]
    jouts = op_cases.numpy_outs(jax_forward(name))
    gins, gattrs = op_cases.grad_inputs(name, jouts)
    jg = jreg.get(c.op + "_grad").lower(
        jreg.LowerCtx(dict(gattrs)),
        {s: [None if a is None else _to_jax(a, c.dtype if s in c.ins else "float32")
             for a in v] for s, v in gins.items()})
    tg = op_cases.grad(name, "cpu", jouts)
    compared = 0
    for slot, vals in c.ins.items():
        if slot + "@GRAD" not in tg:
            continue
        for i, a in enumerate(vals):
            if a.dtype.kind != "f":
                continue
            assert_close(tg[slot + "@GRAD"][i], jg[slot + "@GRAD"][i], c.grad_tol,
                         f"{name} {slot}@GRAD[{i}]")
            compared += 1
    assert compared >= 1, name


def test_every_new_op_type_has_a_case_and_is_registered():
    new = [op for ops in NEW_OPS.values() for op in ops]
    assert len(new) == len(set(new)) == 99
    covered = {c.op for c in CASES.values()} | set(op_cases.RANDOM_CASES)
    assert sorted(set(new) - covered) == []
    for op in new:
        treg.get(op)
        jreg.get(op)
        # the same differentiability as the JAX registration
        assert (treg.get(op).grad is None) == (jreg.get(op).grad is None), op


@pytest.mark.parametrize("name", DENSE)
def test_dense_op_matches_jax_lowering(name):
    check_forward(name)


@pytest.mark.parametrize("name", [n for n in DENSE if CASES[n].grad])
def test_dense_op_grad_matches_jax_vjp(name):
    check_grad(name)


@pytest.mark.parametrize("op", sorted(op_cases.RANDOM_CASES))
def test_random_ops_hold_their_distribution(op):
    attrs, dtype = op_cases.RANDOM_CASES[op]
    jout = np.asarray(jreg.get(op).lower(jreg.LowerCtx(dict(attrs)), {})["Out"][0])
    tout = treg.get(op).lower(treg.LowerCtx(dict(attrs), seed=3, counter=1), {})["Out"][0]
    assert str(tout.dtype) == f"torch.{dtype}"
    assert tout.shape == tuple(attrs["shape"]) == jout.shape
    for out in (jout, tout.numpy()):
        why = op_cases.random_stats(op, out)
        assert why is None, why


def test_random_ops_refuse_capture():
    """A program holding ``randint`` or ``truncated_gaussian_random`` is
    not captured as a CUDA graph: a replay would draw the captured run's
    numbers again."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.executor import capture_refusal
    for op in op_cases.RANDOM_CASES:
        main = pt.Program()
        with pt.program_guard(main, pt.Program()):
            out = main.global_block().create_var("out", (), "float32")
            main.global_block().append_op(op, outputs={"Out": [out]},
                                          attrs=dict(op_cases.RANDOM_CASES[op][0]))
        assert op in capture_refusal(main)


def test_mod_and_floordiv_take_the_divisors_sign():
    """``elementwise_mod`` is ``jnp.mod`` (Python's %, the divisor's sign),
    ``elementwise_floordiv`` floors: -7 % 2 = 1, 7 % -2 = -1, -7 // 2 = -4."""
    outs = op_cases.forward("elementwise_mod-signs", "cpu")["Out"][0]
    assert outs[:4].tolist() == [1.0, -1.0, -1.0, 1.0]
    outs = op_cases.forward("elementwise_floordiv-signs", "cpu")["Out"][0]
    assert outs[:4].tolist() == [-4.0, -4.0, 3.0, 3.0]


def test_clip_bounds_pass_half_the_gradient():
    """relu6 at 0 and 6, as jnp.clip: half the cotangent passes at a bound."""
    outs = op_cases.forward("relu6-bounds", "cpu")
    g = op_cases.grad("relu6-bounds", "cpu", outs)["X@GRAD"][0]
    cot = op_cases.cotangent((5,), 0)
    np.testing.assert_allclose(g.numpy(), cot * np.array([0, 0.5, 1, 0.5, 0]), rtol=1e-6)
