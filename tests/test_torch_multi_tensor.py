"""The multi-tensor optimizer update (``ops/multi_tensor.py``, kernel
``csrc/multi_tensor_update.cu``), held on the CPU.

A run of update ops is one call, in place: its plain version (what a CPU
tensor takes) writes into the inputs exactly what the per-op lowerings
return, and ``trace_block`` splits runs where the attrs change or an op
reads what an earlier one wrote. The kernel runs only on the card
(``chip_smoke.py`` holds it bit for bit against the per-op lowerings there);
what it does with indices is mirrored here: the work table the wrapper
writes (built once per parameter layout and kept), the grid's walk over the
chunks and each block's walk over a chunk's elements, which must cover every
element of every tensor exactly once, and the second pass that advances
each beta power once.
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
        if kind in ("adam", "lamb"):
            ins.update({"Moment1": [f(0.1)], "Moment2": [f(0.01).abs()],
                        "Beta1Pow": [torch.tensor([0.9 ** (i + 1)])],
                        "Beta2Pow": [torch.tensor([0.999 ** (i + 1)])]})
        elif kind in ("momentum", "lars_momentum"):
            ins["Velocity"] = [f(0.1)]
        ins_list.append(ins)
    return ins_list


KINDS = [("adam", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
         ("adam", {"beta1": 0.8, "beta2": 0.99, "epsilon": 1e-6}),
         ("momentum", {"mu": 0.9, "use_nesterov": False}),
         ("momentum", {"mu": 0.95, "use_nesterov": True}),
         ("sgd", {})]


@pytest.mark.parametrize("kind,attrs", KINDS)
def test_a_run_equals_the_per_op_lowerings_bit_for_bit(kind, attrs):
    dtypes = [torch.float32, torch.bfloat16, torch.bfloat16, torch.float32, torch.bfloat16]
    ins_list = _run_inputs(kind, dtypes)
    before = [{s: [t.clone() for t in v] for s, v in ins.items()} for ins in ins_list]
    outs = mt.update(kind, [attrs] * len(ins_list), ins_list)     # one call for the run
    lower = getattr(optimizer_ops, kind)
    assert len(outs) == len(ins_list)
    for ins, ins0, out in zip(ins_list, before, outs):
        ref = lower(LowerCtx(attrs), ins0)
        assert sorted(out) == sorted(ref)
        for slot in ref:
            a, b = out[slot][0], ref[slot][0]
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), slot
            assert a is ins[mt.IN_PLACE[slot]][0], slot       # in place
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
        if kind in ("adam", "lamb"):
            ins = {"Param": [names["Param"]], "Grad": [grad], "LearningRate": [f"lr{i % 2}"],
                   "Moment1": [names["Moment1"]], "Moment2": [names["Moment2"]],
                   "Beta1Pow": [names["Beta1Pow"]], "Beta2Pow": [names["Beta2Pow"]]}
            outs = {"ParamOut": [names["Param"]], "Moment1Out": [names["Moment1"]],
                    "Moment2Out": [names["Moment2"]], "Beta1PowOut": [names["Beta1Pow"]],
                    "Beta2PowOut": [names["Beta2Pow"]]}
        elif kind in ("momentum", "lars_momentum"):
            ins = {"Param": [names["Param"]], "Grad": [grad], "Velocity": [names["Velocity"]],
                   "LearningRate": [f"lr{i % 2}"]}
            outs = {"ParamOut": [names["Param"]], "VelocityOut": [names["Velocity"]]}
        else:
            ins = {"Param": [names["Param"]], "Grad": [grad], "LearningRate": [f"lr{i % 2}"]}
            outs = {"ParamOut": [names["Param"]]}
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
    ([("sgd", {}, None)] * 3 + [("momentum", MOM, None), ("sgd", {}, None)], [3, 1, 1]),
], ids=["one", "adam-attrs", "nesterov", "kinds", "reads-a-write", "sgd"])
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
    monkeypatch.setattr(mt, "update", lambda kind, op_attrs, ins_list: calls.append(
        (kind, len(ins_list))) or update(kind, op_attrs, ins_list))
    env = {k: torch.from_numpy(v).clone() for k, v in feed.items()}
    ref = {k: torch.from_numpy(v).clone() for k, v in feed.items()}
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
    assert desc_bytes == 8 * mt.DESC_SLOTS and len(mt.ROLES) == 7
    assert mt._FLAGS_SLOT < mt.DESC_SLOTS
    assert mt.CHUNK % mt.VEC == 0
    assert "multi_tensor_update" in cuda_build.SOURCES
    assert mt.multi_tensor_update in cuda_build.COUNTED
    assert sorted(cuda_build.SOURCES) == sorted(p.stem for p in Path(cuda_build.CSRC).glob("*.cu"))
    # the kinds the kernel dispatches on are the wrapper's
    src = (Path(cuda_build.CSRC) / "multi_tensor_update.cu").read_text()
    kinds = re.search(r"constexpr int (kAdam = \d+, [^;]*);", src).group(1)
    snake = lambda k: re.sub(r"(?<!^)(?=[A-Z])", "_", k[1:]).lower()
    assert {snake(k): int(v) for k, v in re.findall(r"(k\w+) = (\d+)", kinds)} == mt._KIND
    assert set(mt._KIND) == set(mt.GROUPED) == set(mt._ACCUMULATORS) == set(mt._OUT_SLOTS) \
        == set(mt.LAUNCHES_PER_CALL)


def kernel_walk(table, n_tensors, grid, vector):
    """Mirror of multi_tensor_kernel's loops: block b takes items b, b + grid,
    ...; in an item of chunk c, thread t takes the 8-element groups t, t +
    THREADS, ... of [c * CHUNK, end) when the tensor's flags allow 16-byte
    accesses, then every THREADS-th element of what is left; then
    beta_pow_kernel's thread t advances tensor t's beta powers. Returns
    (times each element is written, per tensor; beta-power writes per
    tensor)."""
    desc = table[:n_tensors * mt.DESC_SLOTS].reshape(n_tensors, mt.DESC_SLOTS)
    items = table[n_tensors * mt.DESC_SLOTS:].view(np.int32).reshape(-1, 2)
    written = [np.zeros(int(n), np.int64) for n in desc[:, mt._N_SLOT]]
    pows = np.zeros(n_tensors, np.int64)
    grid = min(grid, len(items))
    for b in range(grid):
        for c in range(b, len(items), grid):
            t, chunk = items[c]
            n, flags = desc[t, mt._N_SLOT], desc[t, mt._FLAGS_SLOT]
            start = int(chunk) * mt.CHUNK
            end = min(start + mt.CHUNK, int(n))
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
    for b in range(-(-n_tensors // mt.THREADS)):
        for tid in range(mt.THREADS):
            if b * mt.THREADS + tid < n_tensors:
                pows[b * mt.THREADS + tid] += 1
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
        m, v = (torch.zeros(n) for _ in range(2))
        lr, b1p, b2p = (torch.zeros(1) for _ in range(3))
        rows.append((p, g, m, v, lr, b1p, b2p, 0.0))
    table = mt.work_table(rows)
    desc = table[:len(rows) * mt.DESC_SLOTS].reshape(len(rows), mt.DESC_SLOTS)
    for r, d in zip(rows, desc):
        assert list(d[:len(mt.ROLES)]) == [t.data_ptr() for t in r[:len(mt.ROLES)]]
        assert d[mt._N_SLOT] == r[0].numel()
        assert d[mt._FLAGS_SLOT] & (mt._P_BF16 | mt._G_BF16) == mt._P_BF16 | mt._G_BF16
        assert bool(d[mt._FLAGS_SLOT] & mt._VECTOR) == vector
    written, pows = kernel_walk(table, len(rows), grid, vector)
    for n, w in zip(numels, written):
        assert w.shape == (n,) and (w == 1).all(), n
    assert (pows == 1).all()


def test_chunk_table_and_flat_offsets():
    items = mt.chunk_table([0, 5, mt.CHUNK, mt.CHUNK + 1])
    assert items.tolist() == [[0, 0], [1, 0], [2, 0], [3, 0], [3, 1]]


def test_the_wrapper_refuses_cpu_tensors():
    """The kernel wrapper itself takes CUDA tensors only; ``update`` routes
    CPU tensors to the plain version."""
    ins_list = _run_inputs("adam", [torch.float32])
    with pytest.raises(ValueError, match="must lie on"):
        mt.multi_tensor_update("adam", [KINDS[0][1]] * len(ins_list), ins_list)
    assert mt.multi_tensor_update.launches == 0


def _rows(tensors):
    return [(t, t, t, t, t[:1], t[:1], t[:1], 0.0) for t in tensors]


def test_the_table_is_built_once_per_layout(monkeypatch):
    """``table_for`` keeps one device table per layout: the same tensors give
    the same buffer without a rebuild; another pointer, size or dtype gives a
    new one, holding that layout's ``work_table``."""
    monkeypatch.setattr(mt, "_tables", type(mt._tables)())
    a = [torch.zeros(s) for s in (5, 70000, 9)]
    built = mt.tables_built
    t1 = mt.table_for(_rows(a), "cpu")
    assert mt.tables_built == built + 1
    assert torch.equal(t1, torch.from_numpy(mt.work_table(_rows(a))))
    assert mt.table_for(_rows(a), "cpu") is t1 and mt.tables_built == built + 1
    for changed in ([a[0], a[1], torch.zeros(9)],                       # a pointer
                    [a[0], a[1], a[2][:8]],                             # a size
                    [a[0], a[1], a[2].to(torch.bfloat16)]):             # a dtype
        t2 = mt.table_for(_rows(changed), "cpu")
        assert t2 is not t1
        assert torch.equal(t2, torch.from_numpy(mt.work_table(_rows(changed))))
    assert mt.tables_built == built + 4
    assert mt.table_for(_rows(a), "cpu") is t1          # still kept


def test_the_table_cache_is_bounded(monkeypatch):
    monkeypatch.setattr(mt, "_tables", type(mt._tables)())
    keep = [torch.zeros(3) for _ in range(mt.TABLE_CAP + 2)]
    first = mt.table_for(_rows(keep[:1]), "cpu")
    for t in keep[1:]:
        mt.table_for(_rows([t]), "cpu")
    assert len(mt._tables) == mt.TABLE_CAP
    assert mt.table_for(_rows(keep[:1]), "cpu") is not first    # evicted, built again


def test_under_a_capture_the_table_is_the_graphs(monkeypatch):
    """Under a CUDA graph capture each call writes a table of its own (in
    the graph's pool, by captured launches), which the graph holds
    (``graphs.hold``) and the cache does not keep: a pool block may have held
    an earlier node's data, so only the graph's own launches may fill it."""
    from paddle_tpu_torch.core import graphs
    monkeypatch.setattr(mt, "_tables", type(mt._tables)())
    monkeypatch.setattr(mt, "_capturing", lambda device: True)
    held = []
    monkeypatch.setattr(graphs._tls, "held", held, raising=False)
    rows = _rows([torch.zeros(11)])
    t1, t2 = mt.table_for(rows, "cpu"), mt.table_for(rows, "cpu")
    assert t1 is not t2 and held == [t1, t2] and len(mt._tables) == 0
    assert torch.equal(t1, torch.from_numpy(mt.work_table(rows)))


def test_a_fill_launch_fits_its_parameters():
    """fill_table's launch carries kFillWords int64 words, a pointer and a
    count in its parameters: within the 4 KB a launch may take."""
    src = (Path(cuda_build.CSRC) / "multi_tensor_update.cu").read_text()
    words = int(re.search(r"constexpr int kFillWords = (\d+);", src).group(1))
    assert 8 + 8 * words + 4 <= 4096


@pytest.mark.parametrize("kind,attrs", KINDS[::2])
def test_each_kinds_rows_name_its_tensors(kind, attrs):
    """The descriptor's pointer slots (``ROLES``) of each kind: what its ops
    read and write, 0 where the kind has none (``sgd``: neither accumulators
    nor beta powers); the wrapper refuses CPU tensors of every kind."""
    ins_list = _run_inputs(kind, [torch.float32, torch.bfloat16])
    rows = mt.kernel_rows(kind, ins_list, [attrs] * len(ins_list))
    slots = {"adam": ("Moment1", "Moment2", "LearningRate", "Beta1Pow", "Beta2Pow"),
             "momentum": ("Velocity", None, "LearningRate", None, None),
             "sgd": (None, None, "LearningRate", None, None)}[kind]
    for row, ins in zip(rows, ins_list):
        assert len(row) == len(mt.ROLES) + 1 and row[len(mt.ROLES)] == 0.0
        assert row[0] is ins["Param"][0] and torch.equal(row[1], ins["Grad"][0])
        for t, slot in zip(row[2:len(mt.ROLES)], slots):
            assert (t is None) if slot is None else (t is ins[slot][0]), slot
    table = mt.work_table(rows)
    desc = table[:len(rows) * mt.DESC_SLOTS].reshape(len(rows), mt.DESC_SLOTS)
    assert [(d[2:len(mt.ROLES)] == 0).tolist() for d in desc] == \
        [[s is None for s in slots]] * len(rows)
    assert "must lie on" in mt.kernel_refusal(kind, ins_list)
    with pytest.raises(ValueError, match="must lie on"):
        mt.multi_tensor_update(kind, [attrs] * len(ins_list), ins_list)


# ------------------------------------------------- lamb and lars_momentum: two passes

NORMED = [("lamb", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6}),
          ("lars_momentum", {"mu": 0.9, "lars_coeff": 0.001, "lars_weight_decay": 0.0005})]


def _op_attrs(kind, attrs, n):
    """Per-op attrs: lamb's weight decay alternates 0.01 / 0.0 (an excluded
    parameter every other op)."""
    if kind != "lamb":
        return [dict(attrs)] * n
    return [dict(attrs, weight_decay=0.01 if i % 2 == 0 else 0.0) for i in range(n)]


@pytest.mark.parametrize("kind,attrs", NORMED)
def test_a_normed_run_equals_the_per_op_lowerings_bit_for_bit(kind, attrs):
    """The plain version of a lamb / lars_momentum run, each op with its own
    attrs, writes what each op's lowering returns."""
    dtypes = [torch.float32, torch.bfloat16, torch.float32, torch.bfloat16, torch.float32]
    ins_list = _run_inputs(kind, dtypes, seed=3)
    op_attrs = _op_attrs(kind, attrs, len(ins_list))
    ref = [getattr(optimizer_ops, kind)(LowerCtx(a, "cpu"),
                                        {s: [t.clone() for t in v] for s, v in ins.items()})
           for a, ins in zip(op_attrs, ins_list)]
    outs = mt.update(kind, op_attrs, ins_list)
    for out, want, ins in zip(outs, ref, ins_list):
        assert sorted(out) == sorted(want) == sorted(mt._OUT_SLOTS[kind])
        for slot in want:
            assert out[slot][0] is ins[mt.IN_PLACE[slot]][0]
            assert torch.equal(out[slot][0], want[slot][0]), slot


def test_a_lamb_run_spans_excluded_parameters():
    """``weight_decay`` is not a run attr: lamb ops whose decays alternate
    stay one run, one ``update`` call, bit for bit to one op at a time."""
    blk, feed = _update_program([("lamb", a, None) for a in _op_attrs(*NORMED[0], 5)])
    assert [op.attr("weight_decay") for op in blk.ops] == [0.01, 0.0, 0.01, 0.0, 0.01]
    assert mt.run_end(blk.ops, 0) == 5
    env = {k: torch.from_numpy(v).clone() for k, v in feed.items()}
    ref = {k: torch.from_numpy(v).clone() for k, v in feed.items()}
    with torch.no_grad():
        trace_block(blk, env, "cpu")
        trace_block(blk, ref, "cpu", group_updates=False)
    for k in feed:
        assert torch.equal(env[k], ref[k]), k


def norm_passes(table, n_tensors, grid, partials_of):
    """Mirror of norm_pass_kernel and apply_pass_kernel's indices and sums:
    pass 1's block b takes items b, b + grid, ... and writes item c's two
    partial sums (``partials_of(t, chunk)``, float64, rounded to f32) to
    slots 2c and 2c + 1; pass 2 sums a tensor's slots over its descriptor's
    chunk range, in chunk order, in float64, rounds to f32 and takes the
    square root. Returns (writes per slot, per-tensor norms [T, 2] f32,
    the items each tensor's range names)."""
    desc = table[:n_tensors * mt.DESC_SLOTS].reshape(n_tensors, mt.DESC_SLOTS)
    items = table[n_tensors * mt.DESC_SLOTS:].view(np.int32).reshape(-1, 2)
    slots = np.zeros(2 * len(items), np.float32)
    writes = np.zeros(2 * len(items), np.int64)
    for b in range(min(grid, len(items))):
        for c in range(b, len(items), grid):
            t, chunk = items[c]
            slots[2 * c:2 * c + 2] = np.asarray(partials_of(int(t), int(chunk)), np.float32)
            writes[2 * c:2 * c + 2] += 1
    norms = np.zeros((n_tensors, 2), np.float32)
    ranges = []
    for t in range(n_tensors):
        first, count = int(desc[t, mt._FIRST_CHUNK_SLOT]), int(desc[t, mt._N_CHUNKS_SLOT])
        ranges.append(items[first:first + count].tolist())
        pair = slots[2 * first:2 * (first + count)].reshape(-1, 2).astype(np.float64).sum(0)
        norms[t] = np.sqrt(pair.astype(np.float32))
    return writes, norms, ranges


@pytest.mark.parametrize("kind,attrs", NORMED)
def test_the_normed_passes_scratch_layout_and_norms(kind, attrs):
    """The table of a lamb / lars_momentum run: each tensor's weight decay
    (lamb: its op's, as f32 bits in the slot's low half; 0 otherwise) and its
    chunk range; pass 1 writes every scratch slot once, pass 2's range of a
    tensor is exactly its chunks in order, and the norms it sums from the
    partials lie within 1e-6 relative of ``torch.sum``'s (the tolerance the
    card holds the kernel's norms to)."""
    numels = [5, mt.CHUNK + 3, 2 * mt.CHUNK, 17]
    gen = torch.Generator().manual_seed(5)
    ins_list = []
    for n in numels:
        ins = {"Param": [torch.randn(n, generator=gen)], "Grad": [torch.randn(n, generator=gen)],
               "LearningRate": [torch.tensor([0.01])]}
        if kind == "lamb":
            ins.update(Moment1=[torch.randn(n, generator=gen) * 0.1],
                       Moment2=[torch.rand(n, generator=gen) * 0.01],
                       Beta1Pow=[torch.tensor([0.9 ** 2])], Beta2Pow=[torch.tensor([0.999 ** 2])])
        else:
            ins["Velocity"] = [torch.randn(n, generator=gen) * 0.1]
        ins_list.append(ins)
    op_attrs = _op_attrs(kind, attrs, len(numels))
    rows = mt.kernel_rows(kind, ins_list, op_attrs)
    table = mt.work_table(rows)
    T = len(numels)
    desc = table[:T * mt.DESC_SLOTS].reshape(T, mt.DESC_SLOTS)
    want_wd = np.asarray([a["weight_decay"] if kind == "lamb" else 0.0 for a in op_attrs],
                         np.float32)
    assert (desc[:, mt._WD_SLOT].astype(np.uint32).view(np.float32) == want_wd).all()
    assert mt._N_CHUNKS_SLOT < mt.DESC_SLOTS

    def second(t):
        """What the second norm is taken of: lamb's r, lars_momentum's g."""
        ins = ins_list[t]
        if kind == "lars_momentum":
            return ins["Grad"][0]
        a = op_attrs[t]
        g = ins["Grad"][0]
        m = a["beta1"] * ins["Moment1"][0] + (1 - a["beta1"]) * g
        v = a["beta2"] * ins["Moment2"][0] + (1 - a["beta2"]) * g * g
        return (m / (1 - ins["Beta1Pow"][0])) / (torch.sqrt(v / (1 - ins["Beta2Pow"][0]))
                                                + a["epsilon"]) + a["weight_decay"] * ins["Param"][0]

    xs = [(ins_list[t]["Param"][0].numpy(), second(t).numpy()) for t in range(T)]

    def partials_of(t, chunk):
        sl = slice(chunk * mt.CHUNK, (chunk + 1) * mt.CHUNK)
        return [float(np.sum(np.square(x[sl]).astype(np.float64))) for x in xs[t]]

    for grid in (1, 3, 132 * mt.BLOCKS_PER_SM):
        writes, norms, ranges = norm_passes(table, T, grid, partials_of)
        assert (writes == 1).all()
        for t, n in enumerate(numels):
            assert ranges[t] == [[t, c] for c in range(max(1, -(-n // mt.CHUNK)))]
        want = np.array([[torch.sqrt(torch.sum(torch.from_numpy(x) ** 2)).item() for x in pair]
                         for pair in xs], np.float32)
        np.testing.assert_allclose(norms, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind,attrs", NORMED)
def test_the_normed_kinds_rows_and_refusal(kind, attrs):
    """lamb names adam's tensors, lars_momentum momentum's; the wrapper
    refuses CPU tensors (the plain version takes them through ``update``)."""
    ins_list = _run_inputs(kind, [torch.float32, torch.bfloat16])
    rows = mt.kernel_rows(kind, ins_list, _op_attrs(kind, attrs, len(ins_list)))
    like = {"lamb": "adam", "lars_momentum": "momentum"}[kind]
    assert mt._ACCUMULATORS[kind] == mt._ACCUMULATORS[like]
    assert mt._SCALARS[kind] == mt._SCALARS[like]
    for row, ins in zip(rows, ins_list):
        assert row[0] is ins["Param"][0]
        assert (row[3] is None) == (kind == "lars_momentum")
    with pytest.raises(ValueError, match="must lie on"):
        mt.multi_tensor_update(kind, [attrs] * len(ins_list), ins_list)
