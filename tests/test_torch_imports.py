"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and it never falls back to the CPU on its own."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "paddle_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "paddle_tpu")


def _port_files():
    out = []
    for dirpath, _, files in os.walk(PORT):
        out += [os.path.relpath(os.path.join(dirpath, f), ROOT)
                for f in files if f.endswith(".py")]
    return sorted(out) + ["chip_smoke.py"]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


@pytest.mark.parametrize("path", _port_files())
def test_port_module_imports_no_jax(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), path)
    bad = [m for m in _imported_roots(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_port_imports_no_module_by_computed_name():
    """The scan above sees only names written out: a module named at run
    time (``importlib.import_module(f"{pkg.__name__}...")``) could reach the
    JAX package unseen, so the port names every module it imports."""
    bad = []
    for path in _port_files():
        with open(os.path.join(ROOT, path)) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and (
                    getattr(node.func, "id", None) == "__import__"
                    or getattr(node.func, "attr", None) == "import_module") and not (
                    node.args and isinstance(node.args[0], ast.Constant)):
                bad.append(f"{path}:{node.lineno}")
    assert not bad, bad


def test_port_import_leaves_jax_unloaded():
    mods = sorted(p[:-3].replace(os.sep, ".") for p in _port_files()
                  if p.startswith("paddle_tpu_torch"))
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "importlib.import_module('chip_smoke')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n"
            "native = sys.modules['paddle_tpu_torch.native']\n"
            "assert not native._LIB_TRIED, 'importing the port built the slot parser'\n"
            "print(len(sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_importing_the_port_builds_nothing():
    from paddle_tpu_torch.core import cuda_build
    assert cuda_build._loaded == {}


@pytest.fixture(scope="module")
def tiny_model_dir(tmp_path_factory):
    import paddle_tpu_torch as pt
    d = str(tmp_path_factory.mktemp("torch_tiny_model"))
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.data("x", [8], "float32")
        y = pt.layers.fc(x, 4)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(scope):
        exe.run(startup)
        pt.io.save_inference_model(d, ["x"], [y], exe, main_program=main)
    return d


def test_default_device_is_the_card(tiny_model_dir):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.inference import Predictor
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.Executor()
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(tiny_model_dir)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.Executor(pt.CUDAPlace(0))
    out = Predictor(tiny_model_dir, device="cpu").run({"x": np.ones((2, 8), "float32")})
    assert out[0].shape == (2, 4)
