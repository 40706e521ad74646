"""The port's ``nets`` against the JAX package's: the four compositions of
``tests/test_layers_extra.py::test_nets_compositions`` and
``img_conv_group`` (two convs with batch norm, then a pool), each built by
its own package's DSL, in f32, on the same numpy inputs, with the JAX
startup's weights carried across by name. atol 2e-5, rtol 2e-5: f32 sums in
another order (the convolutions, the attention's softmax). On the CPU the
port's ``scaled_dot_product_attention`` runs ``fused_attention``'s plain
version; on the card the same op launches K1-fwd (``chip_smoke.py`` phase
27 B)."""
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert

TOL = dict(rtol=2e-5, atol=2e-5)
RNG = np.random.RandomState(13)
FEED = {"img": RNG.randn(2, 3, 16, 16).astype("float32"),
        "seq": RNG.randn(2, 6, 8).astype("float32"),
        "len": np.array([[6], [4]], "int64")}


def _build(pkg, which):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        iv = pkg.data("img", [3, 16, 16], "float32")
        sv = pkg.data("seq", [6, 8], "float32")
        ln = pkg.data("len", [1], "int64")
        out = {
            "simple_img_conv_pool": lambda: pkg.nets.simple_img_conv_pool(
                iv, 4, 3, 2, 2, conv_padding=1),
            "glu": lambda: pkg.nets.glu(sv, dim=-1),
            "sequence_conv_pool": lambda: pkg.nets.sequence_conv_pool(
                sv, 6, 3, length=ln, pool_type="max"),
            "scaled_dot_product_attention": lambda: pkg.nets.scaled_dot_product_attention(
                sv, sv, sv, num_heads=2),
            "img_conv_group": lambda: pkg.nets.img_conv_group(
                iv, [4, 6], 2, conv_padding=1, conv_filter_size=3, conv_act="relu",
                conv_with_batchnorm=True, pool_stride=2, pool_type="avg"),
        }[which]()
    return main, startup, out


@pytest.mark.parametrize("which,shape", [
    ("simple_img_conv_pool", (2, 4, 8, 8)), ("glu", (2, 6, 4)),
    ("sequence_conv_pool", (2, 6)), ("scaled_dot_product_attention", (2, 6, 8)),
    ("img_conv_group", (2, 6, 8, 8))])
def test_nets_composition_equals_jax(which, shape):
    jm, js, jout = _build(fluid, which)
    tm, _, tout = _build(pt, which)
    assert [op.type for op in tm.global_block().ops] == \
        [op.type for op in jm.global_block().ops]
    feed = {k: v for k, v in FEED.items() if k in {n for op in jm.global_block().ops
                                                   for n in op.input_arg_names()}}
    persist = [n for n, v in jm.global_block().vars.items() if v.persistable]
    exe = fluid.Executor()
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(js)
        init = {n: np.asarray(scope.find_var(n)) for n in persist}
        want, = exe.run(jm, feed=feed, fetch_list=[jout])
    tscope = pt.Scope()
    convert.load_state(tscope, convert.state_from_numpy(init, device="cpu"))
    with pt.scope_guard(tscope):
        got, = pt.Executor(pt.CPUPlace()).run(tm, feed=feed, fetch_list=[tout])
    assert got.shape == shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
