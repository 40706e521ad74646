"""A program the JAX package built, run by the port.

The JAX package runs with 64-bit integers off, so its DSL declares int32
where the reference's op (and the port's lowering) gives int64: mnist's
``top_k`` Indices, ``top_k_0.tmp_1``. The port's ``typecheck`` reports
PT020 on that var (``tests/test_torch_analysis.py``). This file decides
what the declaration means at run time (ROADMAP 3.33): the JAX-built
program, read by ``pt.Program.from_json`` with the JAX package's trained
parameters, runs through the port's ``Executor`` and gives every fetch of
the JAX run, the int32-declared indices and the ops downstream of them
included. Values are compared, integer widths are not (the JAX package's
x64 is off). So the declaration is the JAX package's, the port keeps
Paddle's int64, and PT020 there is a true finding about the JAX program.
"""
import numpy as np

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.models import mnist as jmnist
from paddle_tpu_torch import analysis, convert


def _jax_mnist():
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 0
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.data("img", [1, 28, 28], "float32")
        label = fluid.data("label", [1], "int64")
        loss, acc, logits = jmnist.conv_net(img, label)
        fluid.optimizer.Adam(0.001).minimize(loss)
    return main, startup, [loss.name, acc.name, logits.name]


def _feed(seed, batch=8):
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(batch, 1, 28, 28).astype("float32"),
            "label": rng.randint(0, 10, (batch, 1)).astype("int64")}


def test_fault_3_33_jax_mnist_program_runs_in_the_port_with_equal_fetches():
    """Two JAX Adam steps train the conv net; then the JAX package and the
    port each run a third step of the JAX-built program from the trained
    state. Loss, logits and the parameters after the step: rtol 1e-5 /
    atol 1e-6 (f32, the sums' order differs), the ``top_k`` values too;
    its indices and the accuracy computed from them: equal. The port's indices
    are int64 where the JAX program declares int32."""
    jm, js, fetch = _jax_mnist()
    topk = [op for op in jm.global_block().ops if op.type == "top_k"]
    assert len(topk) == 1
    values, indices = topk[0].outputs["Out"][0], topk[0].outputs["Indices"][0]
    assert indices == "top_k_0.tmp_1"
    assert jm.global_block().vars[indices].dtype == "int32"
    fetch = fetch + [values, indices]
    persist = sorted(n for n, v in jm.global_block().vars.items() if v.persistable)

    exe = fluid.Executor()
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(js)
        for i in range(2):
            exe.run(jm, feed=_feed(i), fetch_list=[fetch[0]])
        trained = {n: np.asarray(scope.find_var(n)) for n in persist}
        jouts = [np.asarray(v) for v in exe.run(jm, feed=_feed(2), fetch_list=fetch)]
        jafter = {n: np.asarray(scope.find_var(n)) for n in persist}

    tm = pt.Program.from_json(jm.to_json())
    assert tm.global_block().vars[indices].dtype == "int32"   # the JAX declaration, read as is
    assert "PT020" in {d.code for d in analysis.verify(tm, fetch_names=fetch)}
    tscope = pt.Scope()
    convert.load_state(tscope, convert.state_from_numpy(trained, device="cpu"))
    with pt.scope_guard(tscope):
        touts = pt.Executor(pt.CPUPlace()).run(tm, feed=_feed(2), fetch_list=fetch)

    loss, acc, logits, topv, topi = touts
    np.testing.assert_allclose(loss, jouts[0], rtol=1e-5)
    np.testing.assert_allclose(logits, jouts[2], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(topv, jouts[3], rtol=1e-5, atol=1e-6)
    assert topi.dtype == np.int64 and jouts[4].dtype == np.int32
    np.testing.assert_array_equal(topi, jouts[4])
    np.testing.assert_array_equal(acc, jouts[1])
    for n in persist:
        np.testing.assert_allclose(tscope.find_var(n).numpy(), jafter[n], rtol=1e-5,
                                   atol=1e-6, err_msg=n)
