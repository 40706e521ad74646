"""The port's C serving ABI (``paddle_tpu_torch/native/serving_capi.cpp``,
built and loaded by ``native/capi.py``) against the JAX package's
(``paddle_tpu/native/serving_capi.cpp``), both driven through ctypes on the
CPU, as a C serving stack would call them.

The small fc model of ``tests/test_c_serving.py`` is built in both packages
under one name guard; the JAX startup's weights are carried into the port
(``convert.state_from_numpy`` / ``load_state``) and each package saves its
own ``save_inference_model`` directory. Tolerances: the port's ABI against
the JAX Predictor ``rtol 1e-5, atol 1e-6`` (an 8 -> 16 -> 3 MLP in f32,
summed in other orders); against the port's Python Predictor, and from four
threads against its solo runs, bit for bit. The return codes and
``pd_predictor_num_outputs`` are the JAX ABI's.
"""
import ctypes
import shutil
import subprocess
import sysconfig
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.inference import Predictor as JPredictor
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.inference import Predictor
from paddle_tpu_torch.native import capi

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ unavailable")

REPO = str(capi.SOURCE.parents[2])
JAX_SRC = f"{REPO}/paddle_tpu/native/serving_capi.cpp"


def _fc(pkg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 4
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [8], "float32")
        h = pkg.layers.fc(x, 16, act="relu")
        y = pkg.layers.fc(h, 3)
    return main, startup, y


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(JAX model dir, port model dir, the JAX library, the port library)."""
    root = tmp_path_factory.mktemp("capi")
    main, startup, y = _fc(fluid)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor()
        exe.run(startup)
        fluid.io.save_inference_model(str(root / "jax"), ["x"], [y], exe, main)
        state = {n: np.asarray(scope.find_var(n)) for n, v in main.global_block().vars.items()
                 if v.persistable and scope.find_var(n) is not None}
    tmain, _, ty = _fc(pt)
    tscope = pt.Scope()
    convert.load_state(tscope, convert.state_from_numpy(state, device="cpu"))
    with pt.scope_guard(tscope):
        pt.io.save_inference_model(str(root / "port"), ["x"], [ty],
                                   pt.Executor(pt.CPUPlace()), tmain)
    jso = str(root / "libpaddle_tpu_capi.so")
    r = subprocess.run(["g++", "-shared", "-fPIC", "-O1", JAX_SRC,
                        f"-I{sysconfig.get_paths()['include']}", "-o", jso],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    jlib = ctypes.CDLL(jso)
    jlib.pd_predictor_create.restype = ctypes.c_void_p
    jlib.pd_predictor_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    for fn in ("pd_predictor_num_outputs", "pd_predictor_destroy"):
        getattr(jlib, fn).argtypes = [ctypes.c_void_p]
    jlib.pd_predictor_run.restype = ctypes.c_int
    jlib.pd_predictor_run.argtypes = capi.load().pd_predictor_run.argtypes
    jlib.pd_last_error.restype = ctypes.c_char_p
    return str(root / "jax"), str(root / "port"), jlib, capi.load()


def _x(batch, seed=0):
    return np.random.RandomState(seed).randn(batch, 8).astype(np.float32)


def test_the_library_is_built_once_under_its_digest():
    path = capi.build()
    assert path.parent == capi.BUILD_DIR and path.name.startswith("libpaddle_tpu_torch_capi-")
    assert capi.build() == path == capi.library_path()


def test_port_abi_serves_the_jax_predictors_outputs(models):
    jdir, tdir, jlib, lib = models
    h = lib.pd_predictor_create_on(tdir.encode(), REPO.encode(), b"cpu")
    assert h, lib.pd_last_error().decode()
    try:
        assert lib.pd_predictor_num_outputs(h) == 1
        x = _x(4)
        out = np.zeros(64, np.float32)
        rc, shape = capi.run(lib, h, {"x": x}, out)
        assert rc == 0, lib.pd_last_error().decode()
        assert shape == (4, 3)
        got = out[:12].reshape(shape)
        ref = np.asarray(JPredictor(jdir).run({"x": x})[0])
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        mine = Predictor(tdir, device="cpu").run({"x": x})[0]
        assert got.tobytes() == np.asarray(mine, np.float32).tobytes()
        # the JAX ABI over its own directory: the same values
        jh = jlib.pd_predictor_create(jdir.encode(), REPO.encode())
        assert jh, jlib.pd_last_error().decode()
        jout = np.zeros(64, np.float32)
        assert capi.run(jlib, jh, {"x": x}, jout) == (0, (4, 3))
        np.testing.assert_allclose(got, jout[:12].reshape(4, 3), rtol=1e-5, atol=1e-6)
        jlib.pd_predictor_destroy(jh)
    finally:
        lib.pd_predictor_destroy(h)


def test_four_threads_get_their_solo_bytes(models):
    _, tdir, _, lib = models
    h = lib.pd_predictor_create_on(tdir.encode(), REPO.encode(), b"cpu")
    assert h, lib.pd_last_error().decode()
    try:
        inputs = [_x(2, seed=s) for s in range(4)]
        solo = []
        for x in inputs:
            out = np.zeros(6, np.float32)
            assert capi.run(lib, h, {"x": x}, out) == (0, (2, 3))
            solo.append(out.tobytes())
        got = [None] * 4
        go = threading.Barrier(4)

        def client(i):
            go.wait()
            outs = []
            for _ in range(5):
                out = np.zeros(6, np.float32)
                outs.append((capi.run(lib, h, {"x": inputs[i]}, out)[0], out.tobytes()))
            got[i] = outs

        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i in range(4):
            assert got[i] == [(0, solo[i])] * 5
    finally:
        lib.pd_predictor_destroy(h)


def test_return_codes_and_errors_are_the_jax_abis(models):
    jdir, tdir, jlib, lib = models
    x = _x(4)
    codes = {}
    for name, l, h in (("jax", jlib, jlib.pd_predictor_create(jdir.encode(), REPO.encode())),
                       ("port", lib, lib.pd_predictor_create_on(tdir.encode(), REPO.encode(),
                                                                b"cpu"))):
        assert h, l.pd_last_error().decode()
        small = np.zeros(2, np.float32)
        short = capi.run(l, h, {"x": x}, small)[0]
        short_msg = l.pd_last_error()
        bad_index = capi.run(l, h, {"x": x}, np.zeros(64, np.float32), out_index=3)[0]
        missing = capi.run(l, h, {"y": x}, np.zeros(64, np.float32))[0]
        null = capi.run(l, None, {"x": x}, np.zeros(64, np.float32))[0]
        null_msg = l.pd_last_error()
        codes[name] = (short, b"too small" in short_msg, bad_index, missing, null,
                       null_msg, l.pd_predictor_num_outputs(h),
                       l.pd_predictor_num_outputs(None))
        l.pd_predictor_destroy(h)
        l.pd_predictor_destroy(None)
        assert not l.pd_predictor_create(b"/nonexistent/model", REPO.encode())
        assert b"Predictor(model_dir)" in l.pd_last_error()
    assert codes["port"] == codes["jax"] == (-2, True, -1, -1, -3, b"bad handle", 1, -1)


def test_create_without_a_card_names_the_card(models):
    if torch.cuda.is_available():
        pytest.skip("this CPU check asserts the refusal without a card")
    _, tdir, _, lib = models
    for h in (lib.pd_predictor_create(tdir.encode(), REPO.encode()),
              lib.pd_predictor_create_on(tdir.encode(), REPO.encode(), b"cuda")):
        assert not h
        msg = lib.pd_last_error().decode()
        assert msg.startswith("Predictor(model_dir)") and "CUDA device" in msg, msg
