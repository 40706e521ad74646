"""The port's FLOP accounting, cost and memory gauges and flags
(``paddle_tpu_torch/utils/flops.py``, ``observability/{cost,memory}.py``,
``flags.py``) against the JAX package's.

``program_flops`` of a 2-layer, H 64 BERT built by each package's DSL, with
and without ``append_backward``, must be the same dict: both count the same
ops from the same shapes, exactly. ``achieved_mfu`` is the same float
expression. The gauges are read after tiny-BERT steps on the CPU under
``PADDLE_TPU_OBS=1`` (sizes: tests/test_torch_training.py's tiny BERT, B 4).
"""
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import flags as jflags
from paddle_tpu.models import bert as jbert
from paddle_tpu.observability import cost as jcost
from paddle_tpu.utils import flops as jflops
import paddle_tpu_torch as pt
from paddle_tpu_torch import flags
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.observability import REGISTRY, cost, journal, memory
from paddle_tpu_torch.utils import flops

from test_torch_training import B, S, VOCAB, _build, _feeds


def _forward(pkg, bert):
    cfg = bert.BertConfig(vocab_size=VOCAB, hidden=64, n_layers=2, n_heads=2,
                          max_seq_len=S, dropout=0.0, dtype="float32")
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        ins = [pkg.data(n, [S], t) for n, t in (("src_ids", "int64"), ("pos_ids", "int64"),
                                                ("sent_ids", "int64"),
                                                ("input_mask", "float32"))]
        ins += [pkg.data(n, [1], "int64") for n in ("mask_pos", "mask_label", "nsp_label")]
        total, _, _ = bert.pretrain(*ins, cfg)
    return main


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "append_backward"])
def test_program_flops_equals_jax(backward):
    if backward:
        tm, jm = _build(pt, tbert)[0], _build(fluid, jbert)[0]
    else:
        tm, jm = _forward(pt, tbert), _forward(fluid, jbert)
    for batch in (1, B):
        got, want = flops.program_flops(tm, batch), jflops.program_flops(jm, batch)
        assert got == want
        assert got["forward"] > 0
        # every counted forward op of BERT has its grad op, at twice its FLOPs
        assert got["backward"] == (2 * got["forward"] if backward else 0)
    assert flops.product_dtype(tm, B) == "float32"


def test_peak_table_and_mfu_equal_jax(monkeypatch):
    monkeypatch.delenv(cost.PEAK_ENV, raising=False)
    h100 = "NVIDIA H100 80GB HBM3"
    assert flops.device_peak_flops(h100) == 989.4e12
    assert flops.device_peak_flops(h100, "float32") == 66.9e12
    assert flops.device_peak_flops("TPU v4") is None      # no TPU rows
    assert flops.device_peak_hbm_bw(h100) == 3.35e12
    assert flops.bandwidth_sanity(4000.0, h100) == (3350.0, True, 3350.0)
    assert flops.bandwidth_sanity(100.0, h100) == (100.0, False, 3350.0)
    for f, s, peak in ((9e12, 0.0869, 989.4e12), (1.0, 1.0, 2.0), (5e9, 0.0, 1e12),
                       (0.0, 1.0, 1e12)):
        assert cost.achieved_mfu(f, s, peak=peak) == jcost.achieved_mfu(f, s, peak=peak)
    assert cost.achieved_mfu(9e12, 0.0869, device_kind=h100) == pytest.approx(0.1047, abs=1e-4)
    monkeypatch.setenv(cost.PEAK_ENV, "1e12")
    assert cost.peak_flops("anything") == jcost.peak_flops("anything") == 1e12


def test_cost_and_memory_gauges_after_cpu_steps(monkeypatch, tmp_path):
    monkeypatch.setenv("PADDLE_TPU_OBS", "1")
    monkeypatch.setenv("PADDLE_TPU_OBS_JOURNAL", str(tmp_path / "j.jsonl"))
    monkeypatch.setenv(cost.PEAK_ENV, "1e12")
    monkeypatch.setenv("PADDLE_TPU_OBS_MEM_INTERVAL", "2")
    main, startup, total, _ = _build(pt, tbert)
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        for _ in range(4):
            exe.run(main, feed=_feeds(), fetch_list=[total])
    label = f"{id(main)}:v{main._version}"
    g = lambda name, **kw: REGISTRY.gauge(name, **kw).value  # noqa: E731
    assert g("program_flops", program=label) == flops.program_flops(main, B)["total"]
    assert g("program_flops_per_sec", program=label) > 0
    assert 0 < g("program_mfu", program=label) < 1
    # the argument bytes: every parameter and moment the step reads, and its feeds
    assert g("program_argument_bytes", program=label) > 4 * 64 * 64 * 4
    assert g("program_output_bytes", program=label) == 4      # one f32 loss
    assert g("device_memory_bytes_in_use", device="cpu:0") > 0
    assert REGISTRY.counter("memory_samples_total", reason="interval").value >= 2
    runs = [e for e in journal.recent(event="run") if e["program"] == id(main)]
    assert [e["cache"] for e in runs] == ["miss", "hit", "hit", "hit"]
    exe.close()
    assert REGISTRY.get("program_flops") is None or \
        not any(("program", label) in k for k, _ in REGISTRY.get("program_flops").items())


def test_memory_helpers():
    import torch
    a = torch.zeros(10)
    assert memory.tensor_bytes([a, a[2:], torch.ones(3, dtype=torch.int64), None]) == 64
    parts = memory.update_program_memory_gauges("p:v0", 8, 4, pool_bytes=None)
    assert parts == {"argument_bytes": 8.0, "output_bytes": 4.0}
    assert memory.update_program_memory_gauges("p:v0", 8, 4, 100)["peak_bytes"] == 100.0
    assert memory.update_static_memory_gauges(None, None, [], [], "p:v0") is None


def test_flags_equal_jax_for_the_shared_flags(monkeypatch):
    shared = set(flags._REGISTRY) & set(jflags._REGISTRY)
    assert shared == set(flags._REGISTRY)
    for n in shared:
        t, j = flags._REGISTRY[n], jflags._REGISTRY[n]
        assert (t.default, t.typ, t.noop) == (j.default, j.typ, j.noop), n
    assert set(jflags._REGISTRY) - shared == set(flags._REFUSED)
    for n in flags._REFUSED:
        with pytest.raises(ValueError, match=n):
            flags.set_flag(n, "x")
        with pytest.raises(KeyError, match=n):
            flags.get_flag(n)
    monkeypatch.setattr(flags._REGISTRY["benchmark"], "value", False)
    flags.set_flags({"FLAGS_benchmark": "1"})
    assert flags.get_flag("benchmark") is True and pt.get_flag("benchmark") is True


def test_benchmark_flag_times_steps_synchronously(monkeypatch):
    """``benchmark`` arms the synchronous timing (a fetch_sync span each run)
    and the anomaly detector without the journal."""
    from paddle_tpu_torch.observability import timeline
    monkeypatch.delenv("PADDLE_TPU_OBS", raising=False)
    monkeypatch.setattr(flags._REGISTRY["benchmark"], "value", True)
    main, startup, total, _ = _build(pt, tbert)
    exe = pt.Executor(pt.CPUPlace())
    before = len(timeline.spans("fetch_sync"))
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        for _ in range(2):
            exe.run(main, feed=_feeds(), fetch_list=[total])
    assert len(timeline.spans("fetch_sync")) - before == 3
    (step,) = [s for k, s in exe._cache.items() if k[0] == id(main)]
    assert len(step.windows) == 1


def test_check_nan_inf_flag_raises(monkeypatch):
    main, startup, total, _ = _build(pt, tbert, lr=np.inf)
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        monkeypatch.setattr(flags._REGISTRY["check_nan_inf"], "value", True)
        with pytest.raises(FloatingPointError, match="FLAGS_check_nan_inf"):
            exe.run(main, feed=_feeds(), fetch_list=[total])


def test_check_dtype_flag(monkeypatch):
    """``check_dtype`` raises on an op that writes another dtype than its
    variable declares, and only while it is set."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.data("x", [4], "float32")
        y = pt.layers.scale(x, 2.0)
    exe = pt.Executor(pt.CPUPlace())
    feed = {"x": np.ones((2, 4), "float32")}
    exe.run(main, feed=feed, fetch_list=[y])
    main.global_block().var(y.name).dtype = "float64"      # declared, not written
    exe.run(main, feed=feed, fetch_list=[y])               # the flag is off
    monkeypatch.setattr(flags._REGISTRY["check_dtype"], "value", True)
    with pytest.raises(TypeError, match="FLAGS_check_dtype"):
        exe.run(main, feed=feed, fetch_list=[y])
    monkeypatch.setattr(flags._REGISTRY["check_dtype"], "value", False)
    exe.run(main, feed=feed, fetch_list=[y])
