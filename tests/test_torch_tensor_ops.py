"""The tensor ops (reshapes, slices, gathers and scatters, pads, the index
choosers, ...): each of their cases in ``paddle_tpu_torch/tools/op_cases.py``
through the JAX lowering and the port's, forward and gradient, with the
helpers and tolerances of ``tests/test_torch_dense_ops.py``; and the tie
orders that the JAX package fixes.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.tools import op_cases
from paddle_tpu_torch.tools.op_cases import CASES
from test_torch_dense_ops import TENSOR_OPS, check_forward, check_grad

TENSOR = sorted(k for k, c in CASES.items() if c.op in TENSOR_OPS)


@pytest.mark.parametrize("name", TENSOR)
def test_tensor_op_matches_jax_lowering(name):
    check_forward(name)


@pytest.mark.parametrize("name", [n for n in TENSOR if CASES[n].grad])
def test_tensor_op_grad_matches_jax_vjp(name):
    check_grad(name)


def test_index_choosers_take_the_first_among_ties():
    """arg_max / arg_min the first index of a tie; argsort stable both
    ways ([1, 3, 3, 2, 3] descending: 1, 2, 4, 3, 0)."""
    assert op_cases.forward("arg_max-ties", "cpu")["Out"][0].tolist() == [1, 0]
    assert op_cases.forward("arg_min-ties", "cpu")["Out"][0].tolist() == [0, 2]
    assert op_cases.forward("argsort-ties-descending", "cpu")["Indices"][0].tolist() == \
        [[1, 2, 4, 3, 0], [0, 1, 4, 2, 3]]
    assert op_cases.forward("argsort-ties", "cpu")["Indices"][0].tolist() == \
        [[0, 3, 1, 2, 4], [2, 3, 0, 1, 4]]


def test_repeated_rows_add_their_gradients():
    """lookup_table with ids 1 x3 and 7 x2: row 1's gradient is the sum of
    its three cotangent rows."""
    outs = op_cases.forward("lookup_table-repeats", "cpu")
    g = op_cases.grad("lookup_table-repeats", "cpu", outs)["W@GRAD"][0]
    cot = op_cases.cotangent(tuple(outs["Out"][0].shape), 0)
    np.testing.assert_allclose(g[1].numpy(), cot[[0, 2, 5]].sum(axis=0), rtol=1e-6)
    assert torch.count_nonzero(g.abs().sum(dim=1)).item() == 3


def test_scatter_add_accumulates_repeats():
    c = CASES["scatter-add-repeats"]
    x, upd = c.ins["X"][0], c.ins["Updates"][0]
    want = x.copy()
    np.add.at(want, c.ins["Ids"][0], upd)
    np.testing.assert_allclose(op_cases.forward("scatter-add-repeats", "cpu")["Out"][0].numpy(),
                               want, rtol=1e-6, atol=1e-6)


def test_pad2d_reflect_and_edge_follow_numpy():
    x = CASES["pad2d-reflect-nchw"].ins["X"][0]
    for mode, np_mode in (("reflect", "reflect"), ("edge", "edge")):
        got = op_cases.forward(f"pad2d-{mode}-nchw", "cpu")["Out"][0].numpy()
        np.testing.assert_array_equal(got, np.pad(x, [(0, 0), (0, 0), (2, 1), (3, 2)],
                                                  mode=np_mode))


def test_strided_slice_takes_negative_strides():
    x = CASES["strided_slice-negative"].ins["Input"][0]
    got = op_cases.forward("strided_slice-negative", "cpu")["Out"][0].numpy()
    np.testing.assert_array_equal(got, x[:, -1:0:-2, 3:-10:-1])
