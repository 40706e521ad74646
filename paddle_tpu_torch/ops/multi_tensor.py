"""Multi-tensor optimizer updates: one hand-written CUDA kernel
(``csrc/multi_tensor_update.cu``) for a run of ``adam``, ``momentum``,
``sgd``, ``lamb`` or ``lars_momentum`` ops, and its plain PyTorch version.

The port's counterpart of the JAX package's ``fuse_all_optimizer_ops``
(``paddle_tpu/compiler.py``), which updates every parameter inside the one
XLA step. ``trace_block`` hands each maximal run of consecutive update ops
of one kind with equal attrs (``run_end``) to ``update``. No op type is
added: the ops, their per-parameter accumulators (``optimizer.py``) and
their per-parameter ``LearningRate`` and ``Beta{1,2}Pow`` tensors stay as
they are.

The plain version is a loop over the per-op lowerings of
``ops/optimizer_ops.py``, whose results are copied into the inputs. The
kernel computes the same f32 arithmetic in the same order, every step
exactly rounded, so it matches them bit for bit. ``lamb`` and
``lars_momentum`` read per-tensor norms (the trust ratio, the local
learning rate): the kernel's first pass writes each chunk's partial sums
of squares to a scratch buffer the wrapper allocates (from the graph's
pool under a capture), its second sums them per tensor in chunk order
(the same norm in every block, the same in every run) and writes the
update. Their moments are bit for bit to the lowerings; the norms differ
from ``torch.sum``'s in rounding only (within 1e-6 relative), and so p'
by an ulp or two. ``lamb``'s weight decay is the tensor's own (in its
descriptor), so a run spans parameters that
``exclude_from_weight_decay_fn`` excludes. The update is in place:
ParamOut, Moment1Out, Moment2Out, VelocityOut and Beta{1,2}PowOut are the
input tensors themselves (the programs name one variable for both), the
counterpart of the JAX step's donated state. A caller that holds a
parameter tensor sees it change.

The kernel reads its work table (pointers, sizes, chunks) from a device
buffer that is built once per parameter layout -- the data pointers, sizes
and dtypes of a run's tensors -- and kept (``table_for``). The table is
written on the stream, by launches that carry its words in their
parameters (``fill_table`` in the .cu source): no copy from the host, no
synchronisation. Under a CUDA graph capture a table is the graph's own, in
its pool, and the graph holds it: its fill launches are captured with the
update, so each replay writes it again just before the update reads it (a
block of the pool may have held an earlier node's data).

Routing is by the device of the tensors: CPU tensors take the plain
version; CUDA tensors launch the kernel, or raise where it refuses the call.
Nothing falls back.
"""
from __future__ import annotations

import collections
import ctypes
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import cuda_build, graphs
from ..core.registry import LowerCtx
from . import optimizer_ops

#: the update op types a run is made of, and the attrs (with the per-op
#: lowering's defaults) that must be equal along a run (``lamb``'s
#: ``weight_decay`` is per tensor, not per run)
GROUPED = {"adam": (("beta1", 0.9), ("beta2", 0.999), ("epsilon", 1e-8)),
           "momentum": (("mu", 0.9), ("use_nesterov", False)),
           "sgd": (),
           "lamb": (("beta1", 0.9), ("beta2", 0.999), ("epsilon", 1e-6)),
           "lars_momentum": (("mu", 0.9), ("lars_coeff", 0.001),
                             ("lars_weight_decay", 0.0005))}
#: the kinds that read per-tensor norms: two passes over a scratch buffer
NORMED = ("lamb", "lars_momentum")
#: the kernel launches each kind makes a call
LAUNCHES_PER_CALL = {"adam": 2, "momentum": 1, "sgd": 1, "lamb": 3, "lars_momentum": 2}

#: the kernel's work item: a chunk of CHUNK elements of one tensor
CHUNK = 65536
#: threads a block; each takes VEC consecutive elements at a time (16-byte
#: loads of bf16, two of f32)
THREADS, VEC = 256, 8
#: the grid's blocks an SM (at most; about 4 of 256 threads are resident at
#: once, the rest take chunks as those finish)
BLOCKS_PER_SM = 16
#: one descriptor per tensor: 16 int64 slots (see the .cu source)
DESC_SLOTS = 16
_P_BF16, _G_BF16, _VECTOR = 1, 2, 4
_KIND = {"adam": 0, "momentum": 1, "sgd": 2, "lamb": 3, "lars_momentum": 4}
#: each kind's f32 accumulators (the tensors of Param's size it updates
#: besides Param), its one-element f32 inputs, and its output slots
_ACCUMULATORS = {"adam": ("Moment1", "Moment2"), "momentum": ("Velocity",), "sgd": (),
                 "lamb": ("Moment1", "Moment2"), "lars_momentum": ("Velocity",)}
_SCALARS = {"adam": ("LearningRate", "Beta1Pow", "Beta2Pow"), "momentum": ("LearningRate",),
            "sgd": ("LearningRate",), "lamb": ("LearningRate", "Beta1Pow", "Beta2Pow"),
            "lars_momentum": ("LearningRate",)}
_OUT_SLOTS = {"adam": ("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut", "Beta2PowOut"),
              "momentum": ("ParamOut", "VelocityOut"), "sgd": ("ParamOut",),
              "lamb": ("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut", "Beta2PowOut"),
              "lars_momentum": ("ParamOut", "VelocityOut")}
_DTYPES = (torch.float32, torch.bfloat16)


def _attr_key(op) -> tuple:
    return tuple(op.attr(k, d) for k, d in GROUPED[op.type])


def run_end(ops: Sequence, i: int) -> int:
    """The end (exclusive) of the run of update ops that starts at
    ``ops[i]``: the following ops of the same type with equal attrs, up to
    one that reads a variable an earlier op of the run writes."""
    first = ops[i]
    key = _attr_key(first)
    written = set(first.output_arg_names())
    j = i + 1
    while (j < len(ops) and ops[j].type == first.type and _attr_key(ops[j]) == key
           and written.isdisjoint(ops[j].input_arg_names())):
        written.update(ops[j].output_arg_names())
        j += 1
    return j


def update(kind: str, op_attrs: Sequence[dict],
           ins_list: List[Dict[str, list]]) -> List[Dict[str, list]]:
    """One run of ``kind`` update ops: each entry of ``op_attrs`` is one op's
    attrs (equal in what ``GROUPED`` names; ``lamb``'s ``weight_decay`` may
    differ) and of ``ins_list`` its inputs (slot -> tensors), and the result
    is each op's outputs, as its own lowering would return them."""
    if ins_list[0]["Param"][0].device.type == "cpu":
        return update_plain(kind, op_attrs, ins_list)
    return multi_tensor_update(kind, op_attrs, ins_list)


#: each op's output slot -> the input slot it overwrites
IN_PLACE = {"ParamOut": "Param", "Moment1Out": "Moment1", "Moment2Out": "Moment2",
            "VelocityOut": "Velocity", "Beta1PowOut": "Beta1Pow", "Beta2PowOut": "Beta2Pow"}


def update_plain(kind, op_attrs, ins_list):
    """The per-op lowerings, one op after the other (op k with
    ``op_attrs[k]``), each op's results copied into its inputs. Returns each
    op's outputs: its input tensors."""
    lower = getattr(optimizer_ops, kind)
    device = ins_list[0]["Param"][0].device
    outs = []
    for k, ins in enumerate(ins_list):
        out = lower(LowerCtx(op_attrs[k], device), ins)
        for slot, vals in out.items():
            ins[IN_PLACE[slot]][0].copy_(vals[0])
        outs.append({slot: [ins[IN_PLACE[slot]][0]] for slot in out})
    return outs


def chunk_table(numels: Sequence[int], chunk: int = CHUNK) -> np.ndarray:
    """The kernel's work items, int32 [C, 2]: (tensor index, chunk index),
    chunk c of tensor t covering elements [c * chunk, min((c + 1) * chunk,
    n_t)). An empty tensor still gets one item: its chunk 0 writes the
    beta-power outputs."""
    counts = np.maximum(1, -(-np.asarray(numels, dtype=np.int64) // chunk))
    tensor = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    first = np.repeat(np.cumsum(counts) - counts, counts)
    return np.stack([tensor, np.arange(len(tensor)) - first], axis=1).astype(np.int32)


def kernel_refusal(kind, ins_list) -> Optional[str]:
    """Why the kernel cannot take this run, or None when it can."""
    if kind not in _KIND:
        return f"unknown update kind {kind!r}"
    dev = ins_list[0]["Param"][0].device
    acc, scalars = _ACCUMULATORS[kind], _SCALARS[kind]
    for k, ins in enumerate(ins_list):
        p, g = ins["Param"][0], ins["Grad"][0]
        for name, t in [("Param", p), ("Grad", g)] + [(s, ins[s][0]) for s in acc + scalars]:
            if t is None or not t.is_cuda or t.device != dev:
                return f"op {k}: {name} must lie on {dev}"
        if not p.is_contiguous():
            return f"op {k}: Param must be contiguous (it is updated in place)"
        if p.dtype not in _DTYPES or g.dtype not in _DTYPES:
            return f"op {k}: Param and Grad must be float32 or bfloat16, got {p.dtype}/{g.dtype}"
        if g.numel() != p.numel():
            return f"op {k}: Grad has {g.numel()} elements, Param {p.numel()}"
        for s in acc:
            t = ins[s][0]
            if t.dtype != torch.float32 or t.numel() != p.numel() or not t.is_contiguous():
                return (f"op {k}: {s} must be a contiguous float32 tensor of Param's "
                        f"{p.numel()} elements, got {t.dtype} {tuple(t.shape)}")
        for s in scalars:
            t = ins[s][0]
            if t.dtype != torch.float32 or t.numel() != 1:
                return f"op {k}: {s} must be one float32 element, got {t.dtype} {tuple(t.shape)}"
    return None


#: a descriptor's pointer slots, in order (each tensor read, or read and
#: written, through one pointer); the roles accessed 8 elements at a time
#: decide whether the tensor takes the 16-byte path
ROLES = ("p", "g", "m", "v", "lr", "b1p", "b2p")
_WIDE_ROLES = (0, 1, 2, 3)
_N_SLOT, _FLAGS_SLOT = len(ROLES), len(ROLES) + 1
#: lamb's weight decay (f32 bits in the slot's low half), then the index of
#: the tensor's first item and its number of items (its chunks)
_WD_SLOT, _FIRST_CHUNK_SLOT, _N_CHUNKS_SLOT = len(ROLES) + 2, len(ROLES) + 3, len(ROLES) + 4


def work_table(rows: Sequence[tuple]) -> np.ndarray:
    """The kernel's table for ``kernel_rows``' rows, int64: one descriptor
    of DESC_SLOTS slots per tensor -- the data pointers of its ROLES (0
    where the kind has none), its element count, its flags (p bf16, g bf16,
    all wide roles 16-byte aligned), its weight decay, the index of its
    first item and its item count -- then ``chunk_table``'s items, one
    (tensor, chunk) int32 pair in each int64."""
    T = len(rows)
    ptrs = np.array([[t.data_ptr() if t is not None else 0 for t in r[:len(ROLES)]]
                     for r in rows], dtype=np.int64).reshape(T, len(ROLES))
    numels = [r[0].numel() for r in rows]
    flags = np.array([(_P_BF16 if r[0].dtype == torch.bfloat16 else 0)
                      | (_G_BF16 if r[1].dtype == torch.bfloat16 else 0) for r in rows],
                     dtype=np.int64)
    wide = ptrs[:, _WIDE_ROLES]
    flags |= np.where((wide % 16 == 0).all(axis=1), _VECTOR, 0)
    chunks = chunk_table(numels)
    table = np.zeros(T * DESC_SLOTS + len(chunks), dtype=np.int64)
    desc = table[:T * DESC_SLOTS].reshape(T, DESC_SLOTS)
    desc[:, :len(ROLES)] = ptrs
    desc[:, _N_SLOT] = numels
    desc[:, _FLAGS_SLOT] = flags
    wds = np.array([r[len(ROLES)] for r in rows], np.float32)
    desc[:, _WD_SLOT] = wds.view(np.uint32).astype(np.int64)
    counts = np.bincount(chunks[:, 0], minlength=T)
    desc[:, _FIRST_CHUNK_SLOT] = np.cumsum(counts) - counts
    desc[:, _N_CHUNKS_SLOT] = counts
    table[T * DESC_SLOTS:] = chunks.view(np.int64).reshape(-1)
    return table


def kernel_rows(kind: str, ins_list, op_attrs: Sequence[dict]) -> List[tuple]:
    """Each op's tensors in ``ROLES`` order, None where ``kind`` has no such
    tensor (``sgd``: no accumulators and no beta powers), then its weight
    decay (``lamb``: the op's ``weight_decay``, the lowering's default 0.01;
    0 for the other kinds). A Grad that is not contiguous is replaced by a
    contiguous copy, which the rows hold until the launch is queued."""
    acc, pows = _ACCUMULATORS[kind], _SCALARS[kind][1:]
    return [(ins["Param"][0], ins["Grad"][0].contiguous(),
             *(ins[s][0] for s in acc), *(None,) * (2 - len(acc)),
             ins["LearningRate"][0], *(ins[s][0] for s in pows), *(None,) * (2 - len(pows)),
             float(a.get("weight_decay", 0.01)) if kind == "lamb" else 0.0)
            for ins, a in zip(ins_list, op_attrs)]


def layout(rows) -> tuple:
    """What a run's table depends on: each tensor's data pointers, its size,
    its Param and Grad dtypes and its weight decay."""
    return tuple(x for r in rows for x in (
        *(t.data_ptr() if t is not None else 0 for t in r[:len(ROLES)]), r[0].numel(),
        r[0].dtype, r[1].dtype, r[len(ROLES)]))


#: tables kept, by layout (the most recently used last)
TABLE_CAP = 16
_tables: "collections.OrderedDict[tuple, torch.Tensor]" = collections.OrderedDict()
_tables_lock = threading.Lock()
#: tables built so far, a plain count for tests and chip_smoke.py
tables_built = 0


def _capturing(device) -> bool:
    return torch.device(device).type == "cuda" and torch.cuda.is_current_stream_capturing()


def _write_table(dev: torch.Tensor, words: np.ndarray):
    """``words`` into ``dev`` in stream order (a plain copy on the CPU)."""
    if dev.device.type != "cuda":
        dev.copy_(torch.from_numpy(words))
        return
    fn = cuda_build.load("multi_tensor_update").fill_table
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev.device):
        rc = fn(dev.data_ptr(), words.ctypes.data, len(words),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"multi_tensor_update: writing the work table failed with CUDA "
                           f"error {rc}")


def table_for(rows, device) -> torch.Tensor:
    """The device buffer holding ``work_table(rows)``: the kept
    one for this layout, else a new one. Under a CUDA graph capture always a
    new one, the graph's (``graphs.hold``), written by captured launches and
    not kept."""
    global tables_built
    capturing = _capturing(device)
    key = (str(device),) + layout(rows)
    dev = None
    if not capturing:
        with _tables_lock:
            dev = _tables.get(key)
            if dev is not None:
                _tables.move_to_end(key)
    if dev is None:
        words = work_table(rows)
        dev = torch.empty((len(words),), dtype=torch.int64, device=device)
        _write_table(dev, words)
        with _tables_lock:
            tables_built += 1
            if not capturing:
                _tables[key] = dev
                while len(_tables) > TABLE_CAP:
                    _tables.popitem(last=False)
    if capturing:
        graphs.hold(dev)
    return dev


_P, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _fn():
    fn = cuda_build.load("multi_tensor_update").multi_tensor_update
    if fn.argtypes is None:
        # table, n_tensors, n_chunks, chunk, kind, b1 1-b1 b2 1-b2 eps mu coeff decay,
        # nesterov, grid, scratch, norms, stream
        fn.argtypes = [_P, _I32, _I32, _I32, _I32] + [_F32] * 8 + [_I32, _I32, _P, _P, _P]
        fn.restype = ctypes.c_int
    return fn


@cuda_build.counted
def multi_tensor_update(kind: str, op_attrs: Sequence[dict], ins_list,
                        norms: Optional[torch.Tensor] = None):
    """Launch the multi-tensor kernel for a run of ``kind`` ops on CUDA
    tensors, in place; returns each op's outputs (its input tensors). Param
    and Grad may be f32 or bf16 (each op its own), the accumulators, the
    learning rate and the beta powers are f32 (``sgd`` has no accumulators).
    ``op_attrs``: each op's attrs (the grouped ones are read from the
    first; ``lamb`` reads each one's ``weight_decay``). ``norms``: for
    ``lamb`` / ``lars_momentum``, an optional f32 CUDA tensor of 2 T
    elements into which the kernel writes each tensor's two norms (|p|, and
    |r| or |g|). Raises ValueError for a run the kernel does not take (see
    ``kernel_refusal``) and RuntimeError if a launch fails. Each call adds
    one to ``multi_tensor_update.launches``; it launches
    ``LAUNCHES_PER_CALL[kind]`` kernels."""
    why = kernel_refusal(kind, ins_list)
    if why is not None:
        raise ValueError(f"multi_tensor_update: {why}")
    dev = ins_list[0]["Param"][0].device
    T = len(ins_list)
    rows = kernel_rows(kind, ins_list, op_attrs)
    table = table_for(rows, dev)
    n_chunks = table.numel() - T * DESC_SLOTS
    scratch = None
    if kind in NORMED:
        # each chunk's two partial sums; freed after the launches are queued (the
        # allocator reuses it in stream order; under a capture it is the graph's)
        scratch = torch.empty((2 * n_chunks,), dtype=torch.float32, device=dev)
        if norms is not None and (norms.device != dev or norms.dtype != torch.float32
                                  or norms.numel() != 2 * T or not norms.is_contiguous()):
            raise ValueError(f"multi_tensor_update: norms must be a contiguous float32 "
                             f"tensor of {2 * T} elements on {dev}")

    attrs = op_attrs[0]
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # 1 - b1 and 1 - b2 in double, then rounded to float (ctypes), as PyTorch
    # rounds the Python scalar (1 - b1) that the per-op lowering multiplies by
    eps = attrs.get("epsilon", dict(GROUPED[kind]).get("epsilon", 1e-8))
    scalars = (b1, 1 - b1, b2, 1 - b2, eps, attrs.get("mu", 0.9),
               attrs.get("lars_coeff", 0.001), attrs.get("lars_weight_decay", 0.0005))
    with torch.cuda.device(dev):
        rc = _fn()(table.data_ptr(), T, n_chunks, CHUNK, _KIND[kind], *scalars,
                   int(bool(attrs.get("use_nesterov", False))),
                   min(n_chunks, sms * BLOCKS_PER_SM),
                   scratch.data_ptr() if scratch is not None else None,
                   norms.data_ptr() if norms is not None and scratch is not None else None,
                   torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"multi_tensor_update: kernel launch failed with CUDA error {rc}")
    cuda_build.launched(multi_tensor_update)
    return [{slot: [ins[IN_PLACE[slot]][0]] for slot in _OUT_SLOTS[kind]} for ins in ins_list]
