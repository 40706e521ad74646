"""The port's per-op attribution (``paddle_tpu_torch/observability/
attribution.py``) and the black box's sections.

The JAX package attributes XLA's HLO; the port profiles a step's eager
first run with a ``record_function`` range per IR op. On the CPU the ops'
self times are attributed (tests/test_torch_training.py's tiny BERT): every
bucket must name an op of the program, and the buckets must sum to the
attributed total. A synthetic card trace pins the placement rule: a kernel
belongs to the innermost IR range open when it was launched, whichever
thread launched it (a grad op's kernels come from autograd's thread).
"""
import json

import pytest

from paddle_tpu.observability import blackbox as jblackbox
import paddle_tpu_torch as pt
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.observability import REGISTRY, attribution, blackbox

from test_torch_training import _build, _feeds


def _op_of(program, key):
    typ, _, where = key.partition("#")
    block, _, idx = where.rpartition(":")
    return program.blocks[int(block or 0)].ops[int(idx)].type == typ


def test_cpu_attribution_of_a_tiny_bert_step(monkeypatch):
    monkeypatch.setenv(attribution.ATTRIB_ENV, "1")
    main, startup, total, _ = _build(pt, tbert)
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        exe.run(main, feed=_feeds(), fetch_list=[total])
        exe.run(main, feed=_feeds(), fetch_list=[total])     # a hit: not profiled again
    a = attribution.lookup_program(main)
    assert a is not None and a.device == "cpu"
    named = {k: v for k, v in a.per_ir.items() if k != attribution.UNATTRIBUTED}
    assert named and all(_op_of(main, k) for k in named)
    assert sum(v["device_seconds"] for v in named.values()) == \
        pytest.approx(a.attributed_device_seconds)
    assert sum(v["device_seconds"] for v in a.per_category.values()) == \
        pytest.approx(a.attributed_device_seconds)
    assert 0.5 < a.coverage <= 1.0
    assert set(a.per_category) <= set(attribution.CATEGORIES)
    assert {"matmul", "elementwise"} <= set(a.per_category)
    types = {k.split("#")[0] for k in named}
    assert {"fused_attention", "fused_attention_grad", "mul", "mul_grad", "adam"} <= types
    # bytes: every op of the step ran, so each has its tensors' bytes
    assert all(v["tensor_bytes"] > 0 for k, v in named.items() if k.startswith("mul#"))
    label = f"{id(main)}:v{main._version}"
    assert REGISTRY.gauge("attributed_device_fraction", program=label).value == a.coverage
    top = a.top_ops(1)[0]
    cat, secs = max(top[1]["categories"].items(), key=lambda kv: kv[1])
    assert REGISTRY.gauge("op_device_seconds", program=label, op=top[0],
                          category=cat).value == secs
    attribution.retire_program(label)
    assert not any(("program", label) in k
                   for k, _ in REGISTRY.get("attributed_device_fraction").items())


def _trace():
    """Ranges on the executor's thread 1; launches from it and from
    autograd's thread 2; one kernel whose launch fell outside every range."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "scan#4", "tid": 1, "ts": 90, "dur": 150},
        {"ph": "X", "cat": "user_annotation", "name": "fused_attention#1:3", "tid": 1,
         "ts": 100, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "fused_attention_grad#9", "tid": 1,
         "ts": 300, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "not an op", "tid": 1, "ts": 0,
         "dur": 1000},
    ]
    launches = [(1, 1, 150), (2, 2, 350), (3, 2, 360), (4, 1, 500), (5, 1, 95)]
    for corr, tid, ts in launches:
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": tid,
                   "ts": ts, "dur": 2, "args": {"correlation": corr}})
    for corr, name, dur in ((1, "void flash_fwd_bf16_kernel<2>(Params)", 40.0),
                            (2, "void bwd_dkdv_bf16_kernel<64>(Params)", 60.0),
                            (3, "sm90_xmma_gemm_bf16bf16_bf16f32", 30.0),
                            (4, "elementwise_kernel", 20.0),
                            (5, "Memcpy DtoD (Device -> Device)", 10.0)):
        ev.append({"ph": "X", "cat": "kernel" if corr != 5 else "gpu_memcpy", "name": name,
                   "tid": 7, "ts": 1000 + corr, "dur": dur, "args": {"correlation": corr}})
    return ev


def test_a_kernel_belongs_to_the_innermost_range_open_at_its_launch():
    a = attribution.attribute_trace(_trace(), {"fused_attention#1:3": 512.0}, "t", "cuda")
    assert a.per_ir["fused_attention#1:3"]["names"] == {
        "void flash_fwd_bf16_kernel<2>(Params)": 40e-6}
    assert a.per_ir["fused_attention_grad#9"]["categories"] == {"attention": 60e-6,
                                                                "matmul": 30e-6}
    assert a.per_ir["scan#4"]["categories"] == {"copy": 10e-6}
    assert a.per_ir[attribution.UNATTRIBUTED]["device_seconds"] == pytest.approx(20e-6)
    assert a.per_ir["fused_attention#1:3"]["tensor_bytes"] == 512.0
    assert a.total_device_seconds == pytest.approx(160e-6)
    assert a.coverage == pytest.approx(140 / 160)
    assert [k for k, _ in a.top_ops(2)] == ["fused_attention_grad#9", "fused_attention#1:3"]


def test_diff_of_two_artifacts(tmp_path, capsys):
    a = attribution.attribute_trace(_trace(), None, "a", "cuda")
    trace = _trace()
    for e in trace:
        if e.get("args", {}).get("correlation") == 2 and e["cat"] == "kernel":
            e["dur"] = 160.0                        # the grad's kernel slowed down
    b = attribution.attribute_trace(trace, None, "b", "cuda")
    attribution.arm_capture(str(tmp_path))
    try:
        attribution.publish(a)
        attribution.publish(b)
    finally:
        attribution.arm_capture(None)
    pa, pb = tmp_path / "attrib_a.json", tmp_path / "attrib_b.json"
    la, lb = attribution.load_artifact(str(pa)), attribution.load_artifact(str(pb))
    assert la.to_dict() == json.loads(json.dumps(a.to_dict()))
    d = attribution.diff_attributions(la, lb)
    assert d["ops"][0]["ir"] == "fused_attention_grad#9" and d["ops"][0]["status"] == "changed"
    assert d["ops"][0]["delta"] == pytest.approx(100e-6)
    cat = {r["category"]: r for r in d["categories"]}
    assert cat["attention"]["seconds_delta"] == pytest.approx(100e-6)
    assert "fused_attention_grad#9" in attribution.format_diff(d)
    assert attribution.main([str(pa), str(pb), "--summary"]) == 0
    out = capsys.readouterr().out
    assert "attribution diff: a -> b" in out and "program a:" in out
    assert attribution.main([str(pa), str(tmp_path / "missing.json")]) == 2


def test_the_black_box_bundle_has_the_jax_bundles_keys():
    assert set(blackbox.snapshot("probe")) == set(jblackbox.snapshot("probe"))
    doc = blackbox.snapshot("probe", error=ValueError("x"))
    assert not [k for k in doc if k.endswith("_error")], doc
    assert {"spans", "counters"} <= set(doc["timeline"]) and doc["alerts"]["armed"] is False
