"""The multi-tensor optimizer update (``ops/multi_tensor.py``, kernel
``csrc/multi_tensor_update.cu``), held on the CPU.

A run of update ops is one call: its plain version (what a CPU tensor takes)
equals the per-op lowerings bit for bit, and ``trace_block`` splits runs
where the attrs change or an op reads what an earlier one wrote. The kernel
runs only on the card (``chip_smoke.py`` holds it bit for bit against the
per-op lowerings there); what it does with indices is mirrored here: the
work table the wrapper writes, the grid's walk over the chunks and each
block's walk over a chunk's elements, which must cover every element of
every tensor exactly once and write each beta power once.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import cuda_build
from paddle_tpu_torch.core.executor import trace_block
from paddle_tpu_torch.core.registry import LowerCtx
from paddle_tpu_torch.ops import multi_tensor as mt
from paddle_tpu_torch.ops import optimizer_ops

SHAPES = [(6, 5), (64,), (3, 3, 2), (1,), (130, 7)]


def _run_inputs(kind, dtypes, seed=0):
    """One op's inputs per entry of ``dtypes`` (its Param and Grad dtype),
    over two learning-rate tensors and each op's own beta powers."""
    rng = np.random.RandomState(seed)
    lrs = [torch.tensor([1e-3]), torch.tensor([0.05])]
    ins_list = []
    for i, dt in enumerate(dtypes):
        shape = SHAPES[i % len(SHAPES)]
        f = lambda scale=1.0: torch.from_numpy((rng.randn(*shape) * scale).astype("float32"))
        ins = {"Param": [f().to(dt)], "Grad": [f().to(dt)], "LearningRate": [lrs[i % 2]]}
        if kind == "adam":
            ins.update({"Moment1": [f(0.1)], "Moment2": [f(0.01).abs()],
                        "Beta1Pow": [torch.tensor([0.9 ** (i + 1)])],
                        "Beta2Pow": [torch.tensor([0.999 ** (i + 1)])]})
        else:
            ins["Velocity"] = [f(0.1)]
        ins_list.append(ins)
    return ins_list


KINDS = [("adam", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
         ("adam", {"beta1": 0.8, "beta2": 0.99, "epsilon": 1e-6}),
         ("momentum", {"mu": 0.9, "use_nesterov": False}),
         ("momentum", {"mu": 0.95, "use_nesterov": True})]


@pytest.mark.parametrize("kind,attrs", KINDS)
def test_a_run_equals_the_per_op_lowerings_bit_for_bit(kind, attrs):
    dtypes = [torch.float32, torch.bfloat16, torch.bfloat16, torch.float32, torch.bfloat16]
    ins_list = _run_inputs(kind, dtypes)
    outs = mt.update(kind, attrs, ins_list)             # one call for the run
    lower = optimizer_ops.adam if kind == "adam" else optimizer_ops.momentum
    assert len(outs) == len(ins_list)
    for ins, out in zip(ins_list, outs):
        ref = lower(LowerCtx(attrs), ins)
        assert sorted(out) == sorted(ref)
        for slot in ref:
            a, b = out[slot][0], ref[slot][0]
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), slot
        assert out["ParamOut"][0].dtype == ins["Param"][0].dtype


def _update_program(specs):
    """A block of update ops, one per spec (kind, attrs, reads): each on its
    own parameter; ``reads`` names a variable the op takes as its Grad."""
    prog = pt.Program()
    blk = prog.global_block()
    feed = {}
    rng = np.random.RandomState(0)
    for n in ("lr0", "lr1"):
        blk.create_var(n, [1], "float32")
        feed[n] = np.array([0.01 if n == "lr0" else 0.1], "float32")
    for i, (kind, attrs, reads) in enumerate(specs):
        names = {s: f"{s.lower()}{i}" for s in ("Param", "Grad", "Moment1", "Moment2",
                                                 "Beta1Pow", "Beta2Pow", "Velocity")}
        for s, n in names.items():
            shape = [1] if s.endswith("Pow") else [4, 3]
            blk.create_var(n, shape, "float32")
            feed[n] = (np.full(shape, 0.9, "float32") if s.endswith("Pow")
                       else rng.randn(*shape).astype("float32"))
            if s == "Moment2":
                feed[n] = np.abs(feed[n])
        grad = reads or names["Grad"]
        if kind == "adam":
            ins = {"Param": [names["Param"]], "Grad": [grad], "LearningRate": [f"lr{i % 2}"],
                   "Moment1": [names["Moment1"]], "Moment2": [names["Moment2"]],
                   "Beta1Pow": [names["Beta1Pow"]], "Beta2Pow": [names["Beta2Pow"]]}
            outs = {"ParamOut": [names["Param"]], "Moment1Out": [names["Moment1"]],
                    "Moment2Out": [names["Moment2"]], "Beta1PowOut": [names["Beta1Pow"]],
                    "Beta2PowOut": [names["Beta2Pow"]]}
        else:
            ins = {"Param": [names["Param"]], "Grad": [grad], "Velocity": [names["Velocity"]],
                   "LearningRate": [f"lr{i % 2}"]}
            outs = {"ParamOut": [names["Param"]], "VelocityOut": [names["Velocity"]]}
        blk.append_op(kind, inputs=ins, outputs=outs, attrs=dict(attrs))
    return blk, feed


ADAM, ADAM2 = KINDS[0][1], KINDS[1][1]
MOM, NESTEROV = KINDS[2][1], KINDS[3][1]


@pytest.mark.parametrize("specs,runs", [
    ([("adam", ADAM, None)] * 4, [4]),
    ([("adam", ADAM, None)] * 2 + [("adam", ADAM2, None)] * 3, [2, 3]),
    ([("momentum", MOM, None)] * 2 + [("momentum", NESTEROV, None)]
     + [("momentum", MOM, None)], [2, 1, 1]),
    ([("adam", ADAM, None), ("momentum", MOM, None), ("momentum", MOM, None),
      ("adam", ADAM, None)], [1, 2, 1]),
    # the third op reads the parameter the first one writes: a new run
    ([("momentum", MOM, None)] * 2 + [("momentum", MOM, "param0")], [2, 1]),
], ids=["one", "adam-attrs", "nesterov", "kinds", "reads-a-write"])
def test_runs_split_where_attrs_change(specs, runs, monkeypatch):
    blk, feed = _update_program(specs)
    ops = blk.ops
    got, i = [], 0
    while i < len(ops):
        j = mt.run_end(ops, i)
        got.append(j - i)
        i = j
    assert got == runs
    calls = []
    update = mt.update
    monkeypatch.setattr(mt, "update", lambda kind, attrs, ins_list: calls.append(
        (kind, len(ins_list))) or update(kind, attrs, ins_list))
    env = {k: torch.from_numpy(v) for k, v in feed.items()}
    ref = {k: torch.from_numpy(v) for k, v in feed.items()}
    with torch.no_grad():
        trace_block(blk, env, "cpu")
        trace_block(blk, ref, "cpu", group_updates=False)
    assert [n for _, n in calls] == runs
    assert [k for k, _ in calls] == [specs[sum(runs[:r])][0] for r in range(len(runs))]
    for k in feed:
        assert torch.equal(env[k], ref[k]), k


# ------------------------------------------------------------- the kernel's indices


def _kernel_constants():
    src = (Path(cuda_build.CSRC) / "multi_tensor_update.cu").read_text()
    grab = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    flags = {n: int(v) for n, v in re.findall(r"(k\w+) = (\d+)", src.split(
        "constexpr long long", 1)[1].split(";", 1)[0])}
    size = int(re.search(r"static_assert\(sizeof\(Desc\) == (\d+)", src).group(1))
    return grab("kThreads"), grab("kVec"), flags, size


def test_the_mirror_reads_the_kernels_constants():
    threads, vec, flags, desc_bytes = _kernel_constants()
    assert (threads, vec) == (mt.THREADS, mt.VEC)
    assert flags == {"kPBf16": mt._P_BF16, "kGBf16": mt._G_BF16, "kVector": mt._VECTOR}
    assert desc_bytes == 8 * mt.DESC_SLOTS and len(mt.ROLES) == 12
    assert mt.CHUNK % mt.VEC == 0 and mt.ALIGN * 2 % 16 == 0
    assert "multi_tensor_update" in cuda_build.SOURCES
    assert mt.multi_tensor_update in cuda_build.COUNTED
    assert sorted(cuda_build.SOURCES) == sorted(p.stem for p in Path(cuda_build.CSRC).glob("*.cu"))


def kernel_walk(table, n_tensors, grid, vector):
    """Mirror of multi_tensor_kernel's loops: block b takes items b, b + grid,
    ...; in an item of chunk c, thread t takes the 8-element groups t, t +
    THREADS, ... of [c * CHUNK, end) when the tensor's flags allow 16-byte
    accesses, then every THREADS-th element of what is left; thread 0 of
    chunk 0 writes the beta powers. Returns (times each element is written,
    per tensor; beta-power writes per tensor)."""
    desc = table[:n_tensors * mt.DESC_SLOTS].reshape(n_tensors, mt.DESC_SLOTS)
    items = table[n_tensors * mt.DESC_SLOTS:].view(np.int32).reshape(-1, 2)
    written = [np.zeros(int(n), np.int64) for n in desc[:, 12]]
    pows = np.zeros(n_tensors, np.int64)
    grid = min(grid, len(items))
    for b in range(grid):
        for c in range(b, len(items), grid):
            t, chunk = items[c]
            n, flags = desc[t, 12], desc[t, 13]
            start = int(chunk) * mt.CHUNK
            end = min(start + mt.CHUNK, int(n))
            if chunk == 0:
                pows[t] += 1
            tail = start
            if flags & mt._VECTOR:
                assert vector
                groups = (end - start) // mt.VEC
                for tid in range(mt.THREADS):
                    for q in range(tid, groups, mt.THREADS):
                        i = start + q * mt.VEC
                        assert i % mt.VEC == 0          # 16-byte aligned for bf16, 32 for f32
                        written[t][i:i + mt.VEC] += 1
                tail = start + groups * mt.VEC
            for tid in range(mt.THREADS):
                written[t][tail + tid:end:mt.THREADS] += 1
    return written, pows


@pytest.mark.parametrize("vector", [True, False])
@pytest.mark.parametrize("grid", [1, 3, 132 * mt.BLOCKS_PER_SM])
def test_the_work_table_covers_every_element_once(vector, grid):
    numels = [1, 7, 8, 9, 255, 2049, mt.CHUNK - 1, mt.CHUNK, mt.CHUNK + 3, 2 * mt.CHUNK + 8]
    offset = 0 if vector else 1          # an odd element offset breaks 16-byte alignment
    rows = []
    for n in numels:
        p = torch.zeros(n + 1, dtype=torch.bfloat16)[offset:offset + n]
        g = torch.zeros(n, dtype=torch.bfloat16)
        m, v, pm, pv = (torch.zeros(n) for _ in range(4))
        pp = torch.zeros(n, dtype=torch.bfloat16)
        lr, b1p, b2p, o1, o2 = (torch.zeros(1) for _ in range(5))
        rows.append((p, g, m, v, lr, b1p, b2p, pp, pm, pv, o1, o2))
    table = mt.work_table(rows)
    desc = table[:len(rows) * mt.DESC_SLOTS].reshape(len(rows), mt.DESC_SLOTS)
    for r, d in zip(rows, desc):
        assert list(d[:12]) == [t.data_ptr() for t in r]
        assert d[12] == r[0].numel()
        assert d[13] & (mt._P_BF16 | mt._G_BF16) == mt._P_BF16 | mt._G_BF16
    written, pows = kernel_walk(table, len(rows), grid, vector)
    for n, w in zip(numels, written):
        assert w.shape == (n,) and (w == 1).all(), n
    assert (pows == 1).all()


def test_chunk_table_and_flat_offsets():
    items = mt.chunk_table([0, 5, mt.CHUNK, mt.CHUNK + 1])
    assert items.tolist() == [[0, 0], [1, 0], [2, 0], [3, 0], [3, 1]]
    offs, total = mt.flat_offsets([1, 8, 9, 3])
    assert offs == [0, 8, 16, 32] and total == 40
    assert all(o % mt.ALIGN == 0 for o in offs)


def test_the_wrapper_refuses_cpu_tensors():
    """The kernel wrapper itself takes CUDA tensors only; ``update`` routes
    CPU tensors to the plain version."""
    ins_list = _run_inputs("adam", [torch.float32])
    with pytest.raises(ValueError, match="must lie on"):
        mt.multi_tensor_update("adam", KINDS[0][1], ins_list)
    assert mt.multi_tensor_update.launches == 0


def test_outputs_are_aligned_views_of_one_buffer_per_dtype():
    ts = [torch.zeros(s, dtype=dt) for s, dt in (((6, 5), torch.bfloat16), ((3,), torch.float32),
                                                 ((7, 1), torch.bfloat16), ((9,), torch.float32))]
    views = mt._flat_views(ts, lambda t: t.dtype, "cpu")
    for t, v in zip(ts, views):
        assert v.shape == t.shape and v.dtype == t.dtype and v.is_contiguous()
        assert v.storage_offset() % mt.ALIGN == 0
        assert (v.data_ptr() - views[0 if t.dtype == torch.bfloat16 else 1].data_ptr()) % 16 == 0
    assert views[0].untyped_storage().data_ptr() == views[2].untyped_storage().data_ptr()
    assert views[1].untyped_storage().data_ptr() == views[3].untyped_storage().data_ptr()
    assert views[2].storage_offset() >= views[0].numel()
