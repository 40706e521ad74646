"""Sequence parallelism in the port (``parallel/ring_attention.py``,
``parallel/ulysses.py`` and ``fused_attention``'s routing under a bound
``sp`` group) over gloo on the CPU, against the JAX package.

One launch of ``tests/torch_dist_runner.py`` at world 2 and one at world 4:

- ring and Ulysses attention at sp 2 and sp 4, causal and not, on each
  rank's sequence block, against the JAX ``ring_attention`` and
  ``ulysses_attention`` on the CPU mesh (each rank's slice of their
  output), and the gradients of q, k and v against the JAX vjp of the same
  output cotangent: rtol 2e-5 / atol 2e-5 on the outputs and rtol 2e-4 /
  atol 2e-4 on the gradients (``tests/test_ring_attention.py``'s and
  ``tests/test_ulysses.py``'s tolerances); heads that do not divide the
  group raise with the JAX wording;
- at world 4, the attention model of ``tests/test_ring_attention.py``
  trained under dp 2 x sp 2 (each rank its rows and its 16 of the 32
  positions), through the ring (``impl="auto"``) and through Ulysses, 4
  Adam steps against the JAX package's one-process run from its startup
  state: losses rtol 2e-4 / atol 1e-5 (the JAX test's), the QKV weight atol
  1e-5, and each path's trace counter moved.

At both worlds, what would attend within the rank's block raises: impl
"composed" over an sp mesh, "pallas" and a [B, 1, S, S] bias under the
bound group.

In this process: ``impl="ring"`` without an sp group raises naming the
impl, and a run without sp does not take the ring.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from tests import torch_dist_runner as runner
from tests.test_torch_collective import run_ranks

_RUNS = {}


def _launch(world, tmp_path_factory):
    if world not in _RUNS:
        tmp = tmp_path_factory.mktemp(f"sp{world}")
        inputs, ref = {}, {}
        cases = ["ring"]
        if world == 4:
            cases.append("sp_train")
            # the one-process reference of both paths (the JAX test's "single")
            main, startup, loss = runner.build_attn(fluid, 21, "auto")
            ref["auto"] = ref["ulysses"] = _jax_train(main, startup, loss, inputs)
        np.savez(tmp / "inputs.npz", **inputs)
        _RUNS[world] = (world, ref, run_ranks(tmp, world, cases, timeout=150))
    return _RUNS[world]


def _jax_train(main, startup, loss, inputs):
    """The JAX one-process run: the losses and the QKV weight after it; the
    startup state goes to the ranks as ``attn/``."""
    exe = fluid.Executor()
    with fluid.scope_guard(fluid.Scope()):
        sc = fluid.global_scope()
        exe.run(startup)
        for n in runner.persistables(main):
            inputs[f"attn/{n}"] = np.asarray(sc.find_var(n))
        losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss])[0]).reshape(()))
                  for f in runner.attn_feeds()]
        return np.asarray(losses, np.float32), np.asarray(sc.find_var("qkv_w"))


@pytest.fixture(scope="module", params=[2, 4])
def sp(request, tmp_path_factory):
    return _launch(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def sp4(tmp_path_factory):
    return _launch(4, tmp_path_factory)


def _jax_attention(kind, world, causal):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from paddle_tpu.parallel import ring_attention, ulysses
    q, k, v, bias, co = runner.ring_inputs(world)
    mesh = Mesh(np.array(jax.devices()[:world]).reshape(world), ("sp",))
    fn = ring_attention.ring_attention if kind == "ring" else ulysses.ulysses_attention

    def f(q_, k_, v_):
        return fn(q_, k_, v_, jnp.asarray(bias), 1.0 / np.sqrt(8), 0.0, causal, 0, mesh)

    @jax.jit
    def out_and_grads(q_, k_, v_, co_):
        out, vjp = jax.vjp(f, q_, k_, v_)
        return out, vjp(co_)

    out, grads = out_and_grads(*(jnp.asarray(a) for a in (q, k, v, co)))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_attention_blocks_and_gradients_match_jax(sp, kind, causal):
    world, _, res = sp
    out, grads = _jax_attention(kind, world, causal)
    blk = out.shape[2] // world
    key = f"{kind}/{'causal' if causal else 'full'}"
    for r in range(world):
        sl = slice(r * blk, (r + 1) * blk)
        np.testing.assert_allclose(res[r][f"{key}/out"], out[:, :, sl], rtol=2e-5, atol=2e-5)
        for n, g in zip("qkv", grads):
            np.testing.assert_allclose(res[r][f"{key}/d{n}"], g[:, :, sl], rtol=2e-4,
                                       atol=2e-4, err_msg=f"d{n} rank {r}")


def test_ulysses_refuses_heads_that_do_not_divide(sp):
    world, _, res = sp
    for r in range(world):
        msg = str(res[r]["ulysses/heads_error"])
        assert "heads per mp shard (3) not divisible by sp=" in msg, msg


@pytest.mark.parametrize("case", ["composed", "pallas", "square_bias"])
def test_attention_that_would_stay_in_the_block_raises_under_sp(sp, case):
    """Under a bound sp group each rank holds its block of the positions:
    impl 'composed' (a model over an sp mesh), 'pallas' and a [B,1,S,S]
    bias would attend within the block, and raise naming impl and bias."""
    world, _, res = sp
    impl, bias = {"composed": ("'composed'", "bias=(4, 1, 1, "),
                  "pallas": ("'pallas'", "bias=(2, 1, 1, 8)"),
                  "square_bias": ("'auto'", "bias=(2, 1, 8, 8)")}[case]
    for r in range(world):
        msg = str(res[r][f"refuse/{case}"])
        assert f"fused_attention under sp={world} holds this rank's block" in msg, msg
        assert f"impl={impl}" in msg and bias in msg, msg


@pytest.mark.parametrize("impl", ["auto", "ulysses"])
def test_dp2_sp2_training_matches_one_process(sp4, impl):
    _, ref, res = sp4
    losses, w = ref[impl]
    for r in range(4):
        np.testing.assert_allclose(res[r][f"sp/{impl}/loss"], losses, rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(res[r][f"sp/{impl}/w"], w, atol=1e-5)
        assert int(res[r][f"sp/{impl}/traces"]) > 0
    assert losses[-1] < losses[0]


def _train_port(impl, steps=1):
    from paddle_tpu_torch.parallel import ring_attention
    main, startup, loss = runner.build_attn(pt, 22, impl)
    before = ring_attention.TRACE_COUNT
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        for f in runner.attn_feeds(steps):
            exe.run(main, feed=f, fetch_list=[loss])
    return ring_attention.TRACE_COUNT - before


def test_impl_ring_raises_without_an_sp_group():
    with pytest.raises(Exception, match="impl='ring' needs a bound sp group"):
        _train_port("ring")
    with pytest.raises(Exception, match="impl='ulysses' needs a bound sp group"):
        _train_port("ulysses")


def test_a_run_without_sp_does_not_take_the_ring():
    assert _train_port("auto", steps=2) == 0
