"""The slice as a whole: one saved inference directory answered by the JAX
package's Predictor and by the port's, weights carried across with
``convert``, and a directory saved by the port loaded by the JAX package.

Tolerances: float32 ``atol 1e-4, rtol 1e-4``. bfloat16 against the JAX
Predictor ``atol 3e-2, rtol 2e-2``: the JAX Predictor runs the program as one
XLA computation whose fusions round bf16 at other places than the JAX
package's own op-by-op evaluation (the two differ by up to 0.047 on this
model, three bf16 ulps at |x| in [2, 4)). Against that op-by-op evaluation
the port is held to ``atol 1e-2, rtol 1e-2`` (one ulp).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core.executor import trace_block as jax_trace_block
from paddle_tpu.inference import Predictor as JaxPredictor
from paddle_tpu.models import bert as jbert
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.inference import Predictor
from paddle_tpu_torch.models import bert as tbert
from tests.test_torch_framework import build_encoder

F32 = dict(atol=1e-4, rtol=1e-4)
BF16_VS_JAX_PREDICTOR = dict(atol=3e-2, rtol=2e-2)
BF16_VS_JAX_OPS = dict(atol=1e-2, rtol=1e-2)
TOL = {"float32": F32, "bfloat16": BF16_VS_JAX_PREDICTOR}


def _requests(S=128, vocab=100):
    """Two requests: a full mask, and a ragged one (rows of 100 and 37 tokens)."""
    rng = np.random.RandomState(0)
    out = []
    for lens in ((S, S), (100, 37)):
        valid = np.arange(S)[None, :] < np.array(lens)[:, None]
        out.append({"src_ids": rng.randint(0, vocab, (2, S)).astype("int64"),
                    "pos_ids": np.tile(np.arange(S), (2, 1)).astype("int64"),
                    "sent_ids": rng.randint(0, 2, (2, S)).astype("int64"),
                    "input_mask": valid.astype("float32")})
    return out


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, np.ndarray) \
        else x.astype(np.float32)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def jax_saved(request, tmp_path_factory):
    """The JAX package builds the tiny encoder, runs startup and saves it."""
    dtype = request.param
    main, startup, feeds, enc = build_encoder(fluid, jbert, dtype)
    scope = fluid.Scope()
    exe = fluid.Executor()
    d = str(tmp_path_factory.mktemp(f"jax_saved_{dtype}"))
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(d, feeds, [enc], exe, main_program=main)
    state = {n: np.asarray(scope.find_var(n)) for n in scope.var_names()}
    jax_outs = [_f32(JaxPredictor(d).run(r)[0]) for r in _requests()]
    return dict(dtype=dtype, dir=d, main=main, feeds=feeds, enc=enc, state=state,
                jax_outs=jax_outs)


def test_port_predictor_answers_the_jax_directory(jax_saved):
    pred = Predictor(jax_saved["dir"], device="cpu")
    assert pred.get_input_names() == jax_saved["feeds"]
    for req, ref in zip(_requests(), jax_saved["jax_outs"]):
        out = pred.run(req)[0]
        assert out.dtype == np.float32 and out.shape == (2, 128, 64)
        np.testing.assert_allclose(out, ref, **TOL[jax_saved["dtype"]])


def test_port_matches_jax_op_by_op(jax_saved):
    """The JAX package's own eager, op-by-op run of the same pruned program."""
    pruned = jax_saved["main"]._prune(jax_saved["feeds"], [jax_saved["enc"].name],
                                      for_test=True)
    pred = Predictor(jax_saved["dir"], device="cpu")
    for req in _requests():
        env = {n: jnp.asarray(v) for n, v in jax_saved["state"].items()}
        env.update({k: jnp.asarray(v) for k, v in req.items()})
        ref = _f32(jax_trace_block(pruned.global_block(), env, jax.random.PRNGKey(0))
                   [jax_saved["enc"].name])
        tol = F32 if jax_saved["dtype"] == "float32" else BF16_VS_JAX_OPS
        np.testing.assert_allclose(pred.run(req)[0], ref, **tol)


def test_weights_carried_across_into_the_ports_own_program(jax_saved):
    main, startup, feeds, enc = build_encoder(pt, tbert, jax_saved["dtype"])
    state = convert.state_from_numpy(jax_saved["state"], device="cpu")
    if jax_saved["dtype"] == "bfloat16":
        assert state["layer0_attn_qkv_w"].dtype == torch.bfloat16
    assert state["word_emb"].dtype == torch.float32
    scope = pt.Scope()
    convert.load_state(scope, state)
    test_prog = main.clone(for_test=True)
    exe = pt.Executor(pt.CPUPlace())
    for req, ref in zip(_requests(), jax_saved["jax_outs"]):
        out, = exe.run(test_prog, feed=req, fetch_list=[enc], scope=scope)
        np.testing.assert_allclose(out, ref, **TOL[jax_saved["dtype"]])


def test_port_saved_directory_loads_in_the_jax_predictor(jax_saved, tmp_path):
    main, startup, feeds, enc = build_encoder(pt, tbert, jax_saved["dtype"])
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(scope):
        exe.run(startup)
        names = pt.io.save_inference_model(str(tmp_path), feeds, [enc], exe,
                                           main_program=main)
    assert names == [enc.name]
    with open(tmp_path / "__manifest__.json") as f:
        head = json.load(f)
    assert head["format_version"] == 2 and head["nranks"] == 1
    assert all({"bytes", "crc32"} <= set(m["chunks"][0]) for m in head["vars"])
    tags = {m["name"]: m["dtype"] for m in head["vars"]}
    assert tags["word_emb"] == "float32"
    assert tags["layer0_attn_qkv_w"] == jax_saved["dtype"]
    jax_pred = JaxPredictor(str(tmp_path))
    port_pred = Predictor(str(tmp_path), device="cpu")
    for req in _requests():
        np.testing.assert_allclose(port_pred.run(req)[0], _f32(jax_pred.run(req)[0]),
                                   **TOL[jax_saved["dtype"]])


def test_serving_dtype_override_matches_jax(jax_saved):
    """A float32 model served in bfloat16 and a bfloat16 model served in
    float32 (the program's own casts still round to bf16): bf16 tolerance."""
    other = "bfloat16" if jax_saved["dtype"] == "float32" else "float32"
    jax_pred = JaxPredictor(jax_saved["dir"], dtype=other)
    port_pred = Predictor(jax_saved["dir"], dtype=other, device="cpu")
    req = _requests()[1]
    out = port_pred.run(req)[0]
    assert out.dtype == np.float32   # bf16 outputs come back widened
    np.testing.assert_allclose(out, _f32(jax_pred.run(req)[0]), **BF16_VS_JAX_PREDICTOR)
    # per-call override back to the native dtype
    np.testing.assert_allclose(port_pred.run(req, dtype=jax_saved["dtype"])[0],
                               jax_saved["jax_outs"][1], **TOL[jax_saved["dtype"]])


def test_create_paddle_predictor_from_config(jax_saved):
    from paddle_tpu.inference import AnalysisConfig as JaxConfig
    from paddle_tpu.inference import create_paddle_predictor as jax_create
    from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
    cfg = AnalysisConfig(jax_saved["dir"])
    cfg.enable_use_gpu(100, 0)
    assert cfg.device == "cuda:0"
    cfg.disable_gpu()
    cfg.enable_bfloat16()
    jcfg = JaxConfig(jax_saved["dir"])
    jcfg.enable_bfloat16()
    req = _requests()[1]
    out = create_paddle_predictor(cfg).run(req)[0]
    np.testing.assert_allclose(out, _f32(jax_create(jcfg).run(req)[0]),
                               **BF16_VS_JAX_PREDICTOR)


def test_predictor_validates_feeds(jax_saved):
    pred = Predictor(jax_saved["dir"], device="cpu")
    req = _requests()[0]
    with pytest.raises(ValueError, match="missing"):
        pred.run({k: v for k, v in req.items() if k != "pos_ids"})
    with pytest.raises(ValueError, match="unexpected"):
        pred.run(dict(req, pos_idz=req["pos_ids"]))
    with pytest.raises(ValueError, match="positional"):
        pred.run([req["src_ids"]])
    with pytest.raises(ValueError, match="serving dtype"):
        pred.run(req, dtype="float16")
    positional = pred.run([req[n] for n in pred.get_input_names()])[0]
    np.testing.assert_array_equal(positional, pred.predict(req)[0])


def test_corrupt_chunk_is_refused(jax_saved, tmp_path):
    import shutil
    d = tmp_path / "copy"
    shutil.copytree(jax_saved["dir"], d)
    path = d / "word_emb.npy"
    data = bytearray(path.read_bytes())
    data[-1] ^= 0xFF
    path.write_bytes(bytes(data))
    with pytest.raises(pt.io.CheckpointCorruption, match="crc32"):
        Predictor(str(d), device="cpu")


def test_convert_keeps_widths_and_reads_tagged_bf16():
    bits = np.array([0x3F80, 0xC000], dtype=np.uint16)          # 1.0, -2.0 in bf16
    state = convert.state_from_numpy(
        {"w": bits, "ids32": np.arange(3, dtype=np.int32),
         "ids64": np.arange(3, dtype=np.int64), "f": np.ones(2, np.float32)},
        device="cpu", dtype_tags={"w": "bfloat16"})
    assert state["w"].dtype == torch.bfloat16
    assert state["w"].float().tolist() == [1.0, -2.0]
    assert state["ids32"].dtype == torch.int32 and state["ids64"].dtype == torch.int64
    assert state["f"].dtype == torch.float32
    ml_bf16 = np.asarray(jnp.asarray([0.5, 3.0], jnp.bfloat16))  # numpy's ml_dtypes bf16
    assert convert.tensor_from_numpy(ml_bf16).float().tolist() == [0.5, 3.0]
    scope = pt.Scope()
    convert.load_state(scope, state)
    assert scope.find_var("ids64") is state["ids64"]


# ------------------------------------------------------ the executable cache


def test_executable_signature_equals_jax(jax_saved):
    """The cache key is the JAX Predictor's ``_executable`` signature, for the
    native serving dtype and for an override."""
    other = "bfloat16" if jax_saved["dtype"] == "float32" else "float32"
    jax_pred = JaxPredictor(jax_saved["dir"])
    pred = Predictor(jax_saved["dir"], device="cpu")
    req = _requests()[0]
    for dtype in (None, other):
        jax_pred.run(req, dtype=dtype)
        pred.run(req, dtype=dtype)
    assert list(pred._compiled) == list(jax_pred._compiled)
    assert list(pred._compiled)[1][0] == other


def test_executable_cache_hits_and_misses(jax_saved):
    pred = Predictor(jax_saved["dir"], device="cpu")
    first, ragged = _requests()
    outs = [pred.run(first)[0], pred.run(ragged)[0], pred.run(first)[0]]
    assert pred._cache_counts == {"hit": 2, "miss": 1}
    np.testing.assert_array_equal(outs[0], outs[2])
    short = {k: v[:, :64] for k, v in first.items()}          # a new shape
    assert pred.run(short)[0].shape == (2, 64, 64)
    pred.run(short)
    assert pred._cache_counts == {"hit": 3, "miss": 2}
    pred.run(first, dtype="bfloat16" if jax_saved["dtype"] == "float32" else "float32")
    assert pred._cache_counts == {"hit": 3, "miss": 3} and len(pred._compiled) == 3
    # the eager reference path bypasses the cache and gives the same bits
    pred._use_graphs = False
    np.testing.assert_array_equal(pred.run(first)[0], outs[0])
    assert pred._cache_counts == {"hit": 3, "miss": 3}


def test_threads_racing_a_new_signature_miss_once(jax_saved):
    import threading
    pred = Predictor(jax_saved["dir"], device="cpu")
    req = _requests()[1]
    barrier = threading.Barrier(4)
    outs, errors = [None] * 4, []

    def serve(i):
        try:
            barrier.wait()
            outs[i] = pred.run(req)[0]
        except Exception as e:   # surfaced by the assert below
            errors.append(e)

    threads = [threading.Thread(target=serve, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert pred._cache_counts == {"hit": 3, "miss": 1} and len(pred._compiled) == 1
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    np.testing.assert_allclose(outs[0], jax_saved["jax_outs"][1], **TOL[jax_saved["dtype"]])


def test_the_card_runs_float32_in_full_precision(monkeypatch):
    """resolve_device, which Executor and Predictor call, turns TF32 off for
    cuBLAS and cuDNN when it picks the card (cuDNN's default is TF32)."""
    from paddle_tpu_torch.core.executor import resolve_device
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)   # restored after
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda", 0)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    torch.backends.cudnn.allow_tf32 = True
    assert resolve_device(pt.CPUPlace()) == torch.device("cpu")
    assert torch.backends.cudnn.allow_tf32 is True      # the CPU leaves them alone


def test_the_card_picks_deterministic_convolutions(monkeypatch):
    """resolve_device also has cuDNN pick deterministic algorithms when it
    picks the card (some convolution gradients add with atomics
    otherwise, and a step would not reproduce); the CPU leaves the flag
    alone."""
    from paddle_tpu_torch.core.executor import resolve_device
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(pt.CPUPlace()) == torch.device("cpu")
    assert torch.backends.cudnn.deterministic is False
    assert resolve_device(None) == torch.device("cuda", 0)
    assert torch.backends.cudnn.deterministic is True
