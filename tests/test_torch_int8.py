"""int8 serving through the port: the ``int8_matmul`` kernel's plain
version, the ``quantized_mul`` / ``dequantize_weight`` ops,
``quantize_weights`` and a quantized tiny BERT, held against the JAX package
on the CPU.

Tolerances:
* the plain version against the Pallas kernel (interpret mode): bit-exact.
  Both compute xs, the codes, the int32 product and (acc * xs) * ws in the
  same order with exactly rounded steps.
* the port's op against the JAX op on the CPU: the JAX op takes its XLA
  fallback, acc * (xs * ws), so the two associations differ by up to one
  f32 ulp before the output rounding: ``rtol 3e-7`` in f32 (2.5 ulps); in
  bf16 that ulp can tip an output across a rounding boundary, one bf16 ulp:
  ``rtol 2^-8``.
* the quantized tiny BERT served by both Predictors: an ulp in one layer's
  output can move one activation code by one step in the next layer's
  quantized_mul (1/127 of that row's abs-max), which the layer norm spreads
  over the row: f32 ``atol 2e-2`` on outputs of unit scale, against int8
  rounding gaps of ~0.1 to the unquantized model. bf16 adds the JAX
  Predictor's own fusion rounding (up to 0.047 on this encoder unquantized,
  tests/test_torch_inference.py): ``atol 6e-2, rtol 2e-2``.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.contrib import quantize as jq
from paddle_tpu.core import registry as jreg
from paddle_tpu.inference import Predictor as JaxPredictor
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops import pallas_int8
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.contrib import quantize as tq
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.inference import Predictor
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import int8_matmul as ti8
from tests.test_torch_framework import build_encoder
from tests.test_torch_inference import _f32, _requests

E2E = {"float32": dict(atol=2e-2, rtol=0), "bfloat16": dict(atol=6e-2, rtol=2e-2)}


def _case(m, k, n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    wf = rng.randn(k, n).astype(np.float32)
    ws = (np.abs(wf).max(0) / 127.0 + 1e-12).astype(np.float32)
    w8 = np.clip(np.round(wf / ws), -127, 127).astype(np.int8)
    return x, w8, ws


def _bf16_np(x):
    """f32 array rounded to bf16 and back (numpy has no bf16)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("shape", [(256, 256, 256), (70, 300, 130), (5, 768, 96)],
                         ids=["aligned", "odd", "thin"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_the_pallas_kernel_bit_for_bit(shape, dtype):
    x, w8, ws = _case(*shape, seed=sum(shape))
    if dtype == "bfloat16":
        x = _bf16_np(x)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    want = np.asarray(pallas_int8.fused_int8_matmul(jx, jnp.asarray(w8), jnp.asarray(ws),
                                                    interpret=True).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = ti8.int8_matmul_plain(tx, torch.from_numpy(w8), torch.from_numpy(ws))
    assert got.dtype == tx.dtype and tuple(got.shape) == (shape[0], shape[2])
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_integer_inputs_are_exact():
    """Rows whose abs-max is 127 quantize with scale 1: the output is the
    exact integer product (tests/test_pallas_int8.py's oracle)."""
    rng = np.random.RandomState(1)
    xi = rng.randint(-126, 127, (64, 128)).astype(np.int64)
    xi[:, 0] = 127
    w = rng.randint(-127, 127, (128, 64)).astype(np.int64)
    got, xs, xq = ti8.int8_matmul_plain(torch.from_numpy(xi).float(),
                                        torch.from_numpy(w).to(torch.int8),
                                        torch.ones(64), return_codes=True)
    np.testing.assert_array_equal(got.numpy(), (xi @ w).astype(np.float32))
    assert (xs == 1).all() and (xq.long().numpy() == xi).all()


def test_codes_round_half_to_even_and_clip():
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -127.0]])
    xs = ti8.row_scales(x)
    assert xs.item() == 1.0
    assert ti8.quantize_rows(x, xs).tolist() == [[127, 0, 2, 2, 0, -2, 126, -127]]
    assert ti8.row_scales(torch.zeros(2, 3)).tolist() == [[np.float32(1e-12)]] * 2


def test_wrapper_takes_the_plain_version_on_the_cpu_only():
    x, w8, ws = _case(8, 32, 16)
    tx, tw, tws = (torch.from_numpy(a) for a in (x, w8, ws))
    before = ti8.int8_matmul.launches
    assert torch.equal(ti8.int8_matmul(tx, tw, tws), ti8.int8_matmul_plain(tx, tw, tws))
    assert ti8.int8_matmul.launches == before          # the plain version launches nothing
    assert "CUDA" in ti8.kernel_refusal(tx, tw, tws)
    assert "int8" in ti8.kernel_refusal(tx, tw.float(), tws)
    with pytest.raises(ValueError, match="int8_matmul"):
        ti8.int8_matmul(tx.to("meta"), tw.to("meta"), tws.to("meta"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_mul_op_matches_jax(dtype):
    x, w8, ws = _case(6 * 5, 48, 40, seed=7)
    x = x.reshape(6, 5, 48)
    if dtype == "bfloat16":
        x = _bf16_np(x)
    attrs = {"x_num_col_dims": 2}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jout = jreg.get("quantized_mul").lower(jreg.LowerCtx(attrs), {
        "X": [jnp.asarray(x, jdt)], "Y": [jnp.asarray(w8)], "YScale": [jnp.asarray(ws)]})
    # a YScale cast to bf16 by a serving-dtype override is widened inside the op
    scale = torch.from_numpy(ws)
    tout = treg.get("quantized_mul").lower(treg.LowerCtx(attrs), {
        "X": [torch.from_numpy(x).to(getattr(torch, dtype))], "Y": [torch.from_numpy(w8)],
        "YScale": [scale]})["Out"][0]
    assert tuple(tout.shape) == (6, 5, 40) and tout.dtype == getattr(torch, dtype)
    tol = dict(rtol=3e-7, atol=1e-30) if dtype == "float32" else dict(rtol=2 ** -8, atol=1e-30)
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout["Out"][0].astype(jnp.float32)), **tol)
    widened = treg.get("quantized_mul").lower(treg.LowerCtx(attrs), {
        "X": [torch.from_numpy(x).to(getattr(torch, dtype))], "Y": [torch.from_numpy(w8)],
        "YScale": [scale.to(torch.bfloat16)]})["Out"][0]
    assert widened.dtype == tout.dtype and torch.isfinite(widened.float()).all()


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_dequantize_weight_op_matches_jax(out_dtype, scale_dtype):
    _, w8, ws = _case(4, 24, 10, seed=3)
    attrs = {"channel_axis": 1, "out_dtype": out_dtype}
    jdt = jnp.bfloat16 if scale_dtype == "bfloat16" else jnp.float32
    jout = jreg.get("dequantize_weight").lower(jreg.LowerCtx(attrs), {
        "X": [jnp.asarray(w8)], "Scale": [jnp.asarray(ws, jdt)]})["Out"][0]
    tout = treg.get("dequantize_weight").lower(treg.LowerCtx(attrs), {
        "X": [torch.from_numpy(w8)],
        "Scale": [torch.from_numpy(ws).to(getattr(torch, scale_dtype))]})["Out"][0]
    assert tout.dtype == getattr(torch, out_dtype)
    np.testing.assert_array_equal(tout.float().numpy(), np.asarray(jout.astype(jnp.float32)))


def test_int8_ops_have_no_grad():
    for op in ("quantized_mul", "dequantize_weight"):
        with pytest.raises(KeyError, match="non-differentiable"):
            treg.get(op + "_grad")
    assert treg.get("quantized_mul").nondiff_inputs == {"Y", "YScale"}
    assert treg.get("dequantize_weight").nondiff_inputs == {"X", "Scale"}


def _shared_consumer_program(pkg, dtype):
    """fc with weight ``tied_w`` and a second consumer of the same weight
    through a non-weight slot (``mean``)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = 9
    startup.random_seed = 9
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [64], dtype)
        h = pkg.layers.fc(x, 64, bias_attr=False, param_attr=pkg.ParamAttr(name="tied_w"))
        wmean = pkg.layers.mean(main.global_block().var("tied_w"))
        out = pkg.layers.elementwise_add(pkg.layers.mean(h), wmean)
    return main, startup, out


def _quantize_both(jmain, tmain, jscope, int8_compute):
    state = {n: np.asarray(jscope.find_var(n)) for n in jscope.var_names()}
    tscope = pt.Scope()
    convert.load_state(tscope, convert.state_from_numpy(state, device="cpu"))
    jdone = jq.quantize_weights(jmain, jscope, int8_compute=int8_compute)
    tdone = tq.quantize_weights(tmain, tscope, int8_compute=int8_compute)
    return jdone, tdone, tscope


def _assert_same_quantization(jmain, tmain, jscope, tscope, jdone, tdone):
    assert tdone == jdone and jdone
    jd, td = jmain.to_dict(), tmain.to_dict()
    assert jd["blocks"][0]["ops"] == td["blocks"][0]["ops"]
    assert jd["blocks"][0]["vars"] == td["blocks"][0]["vars"]
    for name, (_, sname) in jdone.items():
        codes = tscope.find_var(name)
        assert codes.dtype == torch.int8
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jscope.find_var(name)))
        assert tscope.find_var(sname).dtype == torch.float32
        np.testing.assert_array_equal(tscope.find_var(sname).numpy(),
                                      np.asarray(jscope.find_var(sname)))


@pytest.mark.parametrize("int8_compute", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weights_matches_jax_on_bert(dtype, int8_compute):
    jm, js, _, _ = build_encoder(fluid, jbert, dtype)
    tm, _, _, _ = build_encoder(pt, tbert, dtype)
    jscope = fluid.Scope()
    with fluid.scope_guard(jscope):
        fluid.Executor().run(js)
    jdone, tdone, tscope = _quantize_both(jm, tm, jscope, int8_compute)
    _assert_same_quantization(jm, tm, jscope, tscope, jdone, tdone)
    types = [op.type for op in tm.global_block().ops]
    if int8_compute:
        assert types.count("quantized_mul") == 8 and "dequantize_weight" not in types
    else:
        assert types.count("dequantize_weight") == 8 and "quantized_mul" not in types


@pytest.mark.parametrize("int8_compute", [False, True])
def test_shared_consumer_reads_the_dequantized_view(int8_compute):
    jm, js, jout = _shared_consumer_program(fluid, "bfloat16")
    tm, _, tout = _shared_consumer_program(pt, "bfloat16")
    jscope = fluid.Scope()
    with fluid.scope_guard(jscope):
        fluid.Executor().run(js)
    jdone, tdone, tscope = _quantize_both(jm, tm, jscope, int8_compute)
    _assert_same_quantization(jm, tm, jscope, tscope, jdone, tdone)
    blk = tm.global_block()
    deq = [op for op in blk.ops if op.type == "dequantize_weight"]
    assert len(deq) == 1 and deq[0].output("Out") == ["tied_w@deq"]
    assert blk.ops.index(deq[0]) == 0                      # inserted ahead of the fc
    mean_w = [op for op in blk.ops if op.type == "mean"][0]
    assert mean_w.input("X") == ["tied_w@deq"]
    xv = np.random.RandomState(2).randn(8, 64).astype("float32")
    got, = pt.Executor(pt.CPUPlace()).run(tm, feed={"x": xv}, fetch_list=[tout],
                                          scope=tscope)
    with fluid.scope_guard(jscope):
        want, = fluid.Executor().run(jm, feed={"x": xv}, fetch_list=[jout])
    np.testing.assert_allclose(got, _f32(want), atol=2e-2, rtol=2e-2)


def test_quantize_transpiler_facade():
    with pytest.raises(NotImplementedError, match="weight-only"):
        tq.QuantizeTranspiler(activation_quantize_type="moving_average_abs_max")
    t = tq.QuantizeTranspiler()
    with pytest.raises(NotImplementedError, match="QAT"):
        t.training_transpile()
    main, startup, _ = _shared_consumer_program(pt, "float32")
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt.Executor(pt.CPUPlace()).run(startup)
        assert "tied_w" in t.freeze_program(main)
    assert scope.find_var("tied_w").dtype == torch.int8


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def quantized_dirs(request, tmp_path_factory):
    """The tiny BERT encoder, built and initialised by the JAX package,
    quantized with int8_compute=True and saved by each package from the same
    weights; plus the unquantized save."""
    dtype = request.param
    jm, js, feeds, enc = build_encoder(fluid, jbert, dtype)
    tm, _, _, tenc = build_encoder(pt, tbert, dtype)
    jscope = fluid.Scope()
    dirs = {k: str(tmp_path_factory.mktemp(f"int8_{k}_{dtype}")) for k in ("jax", "port", "f")}
    with fluid.scope_guard(jscope):
        exe = fluid.Executor()
        exe.run(js)
        fluid.io.save_inference_model(dirs["f"], feeds, [enc], exe, main_program=jm)
        _, _, tscope = _quantize_both(jm, tm, jscope, True)
        fluid.io.save_inference_model(dirs["jax"], feeds, [enc], exe, main_program=jm)
    with pt.scope_guard(tscope):
        pt.io.save_inference_model(dirs["port"], feeds, [tenc], None, main_program=tm)
    return dict(dtype=dtype, **dirs)


def test_quantized_save_format_is_shared(quantized_dirs):
    heads = {}
    for k in ("jax", "port"):
        with open(f"{quantized_dirs[k]}/__manifest__.json") as f:
            heads[k] = {m["name"]: (m["dtype"], m["shape"]) for m in json.load(f)["vars"]}
    assert heads["port"] == heads["jax"]
    assert heads["port"]["layer0_attn_qkv_w"] == ("int8", [64, 192])
    assert heads["port"]["layer0_attn_qkv_w@scale"] == ("float32", [192])


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_quantized_bert_served_by_both_predictors(quantized_dirs, saved_by):
    d = quantized_dirs[saved_by]
    port = Predictor(d, device="cpu")
    ops = [op.type for op in port.program.global_block().ops]
    assert ops.count("quantized_mul") == 8
    jax_pred = JaxPredictor(d)
    full = Predictor(quantized_dirs["f"], device="cpu")
    for req in _requests():
        got = port.run(req)[0]
        np.testing.assert_allclose(got, _f32(jax_pred.run(req)[0]),
                                   **E2E[quantized_dirs["dtype"]])
        gap = np.abs(got - full.run(req)[0])
        assert 0 < gap.mean() < 0.1, gap.mean()           # int8 rounding, and no more


def test_convert_carries_quantized_state():
    """int8 codes, f32 scales and bf16 weights of a JAX-quantized model cross
    into the port by name, bit for bit and in their own dtypes."""
    jm, js, _, _ = build_encoder(fluid, jbert, "bfloat16")
    jscope = fluid.Scope()
    with fluid.scope_guard(jscope):
        fluid.Executor().run(js)
    done = jq.quantize_weights(jm, jscope, int8_compute=True)
    state = {n: np.asarray(jscope.find_var(n)) for n in jscope.var_names()}
    tstate = convert.state_from_numpy(state, device="cpu")
    name, (_, sname) = next(iter(done.items()))
    assert tstate[name].dtype == torch.int8 and tstate[sname].dtype == torch.float32
    assert tstate["layer_norm_0.w_0"].dtype == torch.bfloat16
    for n, a in state.items():
        b = tstate[n]
        np.testing.assert_array_equal(b.float().numpy() if b.dtype == torch.bfloat16
                                      else b.numpy(), _f32(a) if "bfloat16" in str(a.dtype)
                                      else a, err_msg=n)


def test_serving_dtype_override_casts_the_scales(quantized_dirs):
    """A quantized model served in the other float dtype: the Predictor casts
    every float state, the scales included (to bf16 for the f32 model), never
    the int8 codes, and the int8 ops widen the scales again, as in the JAX
    package (bf16 tolerance: one side of each pair runs in bf16)."""
    other = "bfloat16" if quantized_dirs["dtype"] == "float32" else "float32"
    port = Predictor(quantized_dirs["port"], dtype=other, device="cpu")
    state = port._state_for(other)
    assert state["layer0_attn_qkv_w@scale"].dtype == getattr(torch, other)
    assert state["layer0_attn_qkv_w"].dtype == torch.int8
    req = _requests()[1]
    np.testing.assert_allclose(port.run(req)[0],
                               _f32(JaxPredictor(quantized_dirs["port"], dtype=other)
                                    .run(req)[0]), **E2E["bfloat16"])
