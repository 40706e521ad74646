"""The port's comm layer (``paddle_tpu_torch/comm/``) against the JAX
package's on the same numpy inputs, hermetically (no process group): the
int8 quantizer's bounds, the wire-byte formulas, the ``plan_transfer``
table, the gradient-sync rewrite (idempotence, strip, byte floor, ZeRO
fallback, orphan gradients, the port's explicit mode), the strategy knob's
round trip, the ``comm.compress`` choice and the CLI selftest (the cases of
``tests/test_comm.py`` that need no mesh)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import comm as jcomm
from paddle_tpu_torch import comm as tcomm
from paddle_tpu_torch.comm import compress, cost, reshard, rewrite

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_int8_quantize_matches_jax_and_its_bound():
    import jax.numpy as jnp
    rs = np.random.RandomState(3)
    x = (rs.randn(2048) * 7).astype("float32")
    q, s = compress.quantize_int8(torch.from_numpy(x))
    jq, js = jcomm.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(s), float(js), rtol=1e-7)
    back = compress.dequantize_int8(q, s).numpy()
    assert np.abs(back - x).max() <= np.abs(x).max() / 254.0 + 1e-7
    q0, s0 = compress.quantize_int8(torch.zeros(32))
    assert float(compress.dequantize_int8(q0, s0).abs().max()) == 0.0
    q2, s2 = compress.quantize_int8(torch.full((8,), 3.5))
    np.testing.assert_allclose(compress.dequantize_int8(q2, s2).numpy(), 3.5, rtol=1e-2)


@pytest.mark.parametrize("kind", sorted(cost._FORMULAS))
def test_wire_bytes_match_jax(kind):
    for n in (1, 2, 4, 8):
        for nb in (1000, 1 << 20):
            assert cost.wire_bytes(kind, nb, n) == jcomm.wire_bytes(kind, nb, n)
    for dt in ("float32", "bfloat16", "int8", "int64", "float16", "bool"):
        assert cost.dtype_wire_bytes(dt) == jcomm.dtype_wire_bytes(dt)
    for mode in ("off", "bf16", "int8"):
        assert cost.compressed_bytes(1 << 20, "float32", mode, 8) == \
            jcomm.compressed_bytes(1 << 20, "float32", mode, 8)
        assert cost.compression_ratio(1 << 20, "float32", mode, 8) == \
            jcomm.compression_ratio(1 << 20, "float32", mode, 8)


def _plans(mod):
    S, P = mod.ShardSpec, mod.plan_transfer
    regions = mod.regions_for([48, 8], S(0, 3))
    return [P([48, 8], "float32", S(0, 4), S(0, 4)),
            P([48, 8], "float32", S(None), S(0, 4)),
            P([48, 8], "float32", S(0, 4), S(None)),
            P([48, 8], "float32", S(0, 4), S(0, 8)),
            P([48, 8], "float32", S(0, 8), S(0, 4)),
            P([48, 8], "float32", S(0, 4), S(1, 4)),
            P([48, 8], "float32", S(0, 8), S(0, 6)),
            P([48, 8], "bfloat16", regions, [regions[1], regions[0], regions[2]])]


def test_plan_transfer_table_matches_jax():
    for t, j in zip(_plans(reshard), _plans(jcomm)):
        assert t.to_dict() == j.to_dict()
        assert t.summary() == j.summary()


def _toy_program(pkg, grad_shape=(256, 256)):
    p = pkg.Program()
    gb = p.global_block()
    gb.create_parameter("w", grad_shape, "float32")
    gb.create_var("w@GRAD", grad_shape, "float32")
    gb.create_var("lr", (1,), "float32", persistable=True)
    gb.append_op("matmul", inputs={"X": ["w"], "Y": ["w"]},
                 outputs={"Out": ["w@GRAD"]}, infer_shape=False)
    gb.append_op("sgd", inputs={"Param": ["w"], "Grad": ["w@GRAD"], "LearningRate": ["lr"]},
                 outputs={"ParamOut": ["w"]}, infer_shape=False)
    return p


def _cp(pkg, p, mode, dp=2, min_bytes=0, reduce_mode=False):
    ds = pkg.DistributedStrategy(mesh_shape={"dp": dp})
    ds.comm_compression = mode
    ds.comm_compress_min_bytes = min_bytes
    bs = pkg.BuildStrategy()
    if reduce_mode:
        bs.reduce_strategy = pkg.BuildStrategy.ReduceStrategy.Reduce
    return pkg.CompiledProgram(p, build_strategy=bs).with_strategy(ds)


def _ops(p):
    return [(o.type, dict(o.inputs), dict(o.outputs), dict(o.attrs))
            for o in p.global_block().ops]


def test_rewrite_inserts_sync_and_residual_idempotently_as_jax():
    tp, jp = _toy_program(pt), _toy_program(fluid)
    info = rewrite.sync_program(tp, _cp(pt, tp, "int8"))
    assert info == jcomm.sync_program(jp, _cp(fluid, jp, "int8"))
    assert _ops(tp) == _ops(jp)
    res = tp.global_block().vars[compress.residual_name("w@GRAD")]
    assert res.persistable and tuple(res.shape) == (2, 256, 256)
    v = tp._version
    assert rewrite.sync_program(tp, _cp(pt, tp, "int8")) == info
    assert tp._version == v    # warm re-sync: zero mutation


def test_rewrite_strips_on_mode_off_and_world_1():
    p = _toy_program(pt)
    rewrite.sync_program(p, _cp(pt, p, "int8"))
    assert rewrite.sync_program(p, _cp(pt, p, "off")) is None
    assert not any(op.attr(rewrite.SYNC_ATTR) for op in p.global_block().ops)
    assert not any(compress.is_residual(n) for n in p.global_block().vars)
    p2 = _toy_program(pt)
    assert rewrite.sync_program(p2, _cp(pt, p2, "int8", dp=1)) is None


def test_rewrite_falls_back_under_zero_and_respects_the_floor():
    p = _toy_program(pt)
    with pytest.warns(UserWarning, match="ReduceStrategy.Reduce"):
        assert rewrite.sync_program(p, _cp(pt, p, "int8", reduce_mode=True)) is None
    p2 = _toy_program(pt)
    info = rewrite.sync_program(p2, _cp(pt, p2, "int8", min_bytes=1 << 30))
    assert info is not None and info["compressed"] == []
    op, = [o for o in p2.global_block().ops if o.attr(rewrite.SYNC_ATTR)]
    assert op.attr("comm_compress") == "off" and "ResidualIn" not in op.inputs


def test_explicit_mode_syncs_every_gradient():
    """The port's data parallel: with compression off, at world 1 and under
    ZeRO the gradients still pass through a plain c_allreduce_avg."""
    for kw in ({"mode": "off"}, {"mode": "int8", "dp": 1},
               {"mode": "off", "reduce_mode": True}):
        p = _toy_program(pt)
        info = rewrite.sync_program(p, _cp(pt, p, **kw), explicit=True)
        op, = [o for o in p.global_block().ops if o.attr(rewrite.SYNC_ATTR)]
        assert op.type == "c_allreduce_avg" and op.attr("comm_compress") == "off", kw
        assert info["compressed"] == []
        assert not any(compress.is_residual(n) for n in p.global_block().vars)


def test_orphan_gradient_falls_back_or_raises_in_explicit_mode():
    p = pt.Program()
    gb = p.global_block()
    gb.create_parameter("w", (64, 64), "float32")
    gb.create_var("g_ext", (64, 64), "float32", is_data=True)
    gb.create_var("lr", (1,), "float32", persistable=True)
    gb.append_op("sgd", inputs={"Param": ["w"], "Grad": ["g_ext"], "LearningRate": ["lr"]},
                 outputs={"ParamOut": ["w"]}, infer_shape=False)
    with pytest.warns(UserWarning, match="no\\s+global-block producer"):
        assert rewrite.sync_program(p, _cp(pt, p, "int8")) is None
    with pytest.raises(NotImplementedError, match="no global-block producer"):
        rewrite.sync_program(p, _cp(pt, p, "off"), explicit=True)


def test_strategy_knob_validation_and_round_trip():
    ds = pt.DistributedStrategy(mesh_shape={"dp": 4}, comm_compression="bf16")
    with pytest.raises(ValueError, match="comm_compression"):
        ds.comm_compression = "fp8"
    ds.comm_compress_min_bytes = 123
    d = ds.to_dict()
    jd = fluid.DistributedStrategy(mesh_shape={"dp": 4}, comm_compression="bf16")
    jd.comm_compress_min_bytes = 123
    assert d == jd.to_dict()
    ds2 = pt.DistributedStrategy.from_dict(d)
    assert ds2.comm_compression == "bf16" and ds2.comm_compress_min_bytes == 123
    p = _toy_program(pt)
    s1 = pt.CompiledProgram(p).with_strategy(ds).strategy_signature()
    ds3 = pt.DistributedStrategy.from_dict(d)
    ds3.comm_compression = "off"
    assert s1 != pt.CompiledProgram(p).with_strategy(ds3).strategy_signature()
    assert pt.DistributedStrategy().data_spec("x", 3) == ("dp", None, None)


def test_comm_compress_tunable_choice():
    from paddle_tpu_torch import tuning
    small = {"nbytes": 1024, "dtype": "float32", "world": 4, "mode": "int8",
             "min_bytes": 65536}
    big = dict(small, nbytes=1 << 20)
    ch = tuning.get_choice("comm.compress")
    assert ch.candidates(small) == ["off"]
    assert ch.candidates(big) == ["off", "on"]
    assert ch.candidates(dict(big, world=1)) == ["off"]
    assert tuning.decide("comm.compress", small, allow_search=False) == "off"


def test_error_feedback_and_selftest_cli():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.comm", "--selftest"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 failure(s)" in out.stdout
    assert tcomm.selftest() == 0
